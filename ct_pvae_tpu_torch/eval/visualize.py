"""Single-example visualisation panels (port of ``ct_pvae_tpu/eval/visualize.py``).

The reference's CT_VAE.visualization (main_ct_vae.py:488-633), as the JAX
package writes it (visualize.py:43-123): the eval step re-run on one
example tiled to the batch, the full sinogram re-noised, the sample
projected back to a sinogram with the gather ``radon``, the classical ramp
FBP of the noisy full and partial sinograms, and the MSE/SSIM/PSNR of
those (clipped to [0, 1]), the sample and the posterior mean against the
ground truth.

``visualize_arrays`` does the device work and returns the panels and
metrics; ``write_panels`` draws the PNGs (matplotlib, imported there);
``visualize_run`` does both.  Random numbers come from one
``torch.Generator`` seeded ``cfg.seed + 11`` on the run's device: the eval
step's draws, then the Poisson re-noising, as the JAX package splits them
from ``PRNGKey(cfg.seed + 11)``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..data import io as data_io
from ..data.masks import poisson_measurements
from ..data.recon_init import crop_center
from ..device import DeviceLike, exact_f32
from ..ops.fbp import fbp
from ..ops.radon import radon
from ..vi.loss import Draws, DrawSource, GeneratorDraws
from .metrics import compare
from .plots import pyplot

_EPS = float(np.finfo(np.float32).eps)

# (panel, title, colour range: None, or "noisy" for the noisy sinogram's, or
# "partial" for that range with its top divided by num_sparse_angles)
PANELS = (
    ("ActualSinogramNoisy", "Actual Sinogram", None),
    ("ComputedSinogram", "Computed Sinogram", "noisy"),
    ("InputPartialSinogram", "Input Partial Sinogram", "partial"),
    ("ReconFromActualSinogram", "Recon from Actual Sinogram", None),
    ("ReconFromPVAE", "Recon from P-VAE", None),
    ("ReconFromPVAEMean", "Recon from P-VAE (posterior mean)", None),
    ("ReconFromInputPartialSinogram", "Recon from Partial Sinogram", None),
    ("GroundTruth", "Ground Truth", None),
)


def _plot(plt, save_path: str, name: str, img, vmin=None, vmax=None, title=None) -> None:
    plt.figure()
    if title:
        plt.title(title)
    plt.imshow(np.asarray(img), cmap="gray", vmin=vmin, vmax=vmax)
    plt.colorbar()
    plt.savefig(os.path.join(save_path, name + ".png"))
    plt.close()


def visualize_arrays(cfg: Config, trainer, draws: Optional[Union[Draws, DrawSource]] = None
                     ) -> Dict[str, object]:
    """The eval step on example ``cfg.example_num`` tiled to the batch and
    the classical reconstructions: a dict of the panels (host arrays, keyed
    by PNG name; "GroundTruth" where the dataset has one), the step's
    "loss_M_VAE", "kl_divergence" and "loglik", and "results" (the metrics
    of ``visualize_run``).  ``draws``: the eval step's draws (default: the
    generator's)."""
    dev = trainer.device
    en = cfg.example_num
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 11)
    idx = torch.full((cfg.batch_size,), en, dtype=torch.long, device=dev)
    loss, aux = trainer.eval_step(idx, GeneratorDraws(gen, dev) if draws is None else draws)
    out: Dict[str, object] = {"loss_M_VAE": float(loss), "kl_divergence": float(aux.kl.mean()),
                              "loglik": float(aux.loglik)}
    for key in ("loss_M_VAE", "kl_divergence", "loglik"):
        print(key, out[key])

    theta = trainer.theta
    p, fx, fy = trainer.n_det, trainer.x_size, trainer.y_size
    actual = torch.as_tensor(np.asarray(trainer.x_train_sinograms[en], np.float32), device=dev)
    actual_noisy = poisson_measurements(actual, trainer.pnm, gen)
    recon_sample = aux.recon_sample[0]
    computed = radon(recon_sample, torch.as_tensor(theta, device=dev), pad=not cfg.no_pad, n_det=p)
    partial = np.asarray(trainer.all_proj_samples[en], np.float32)
    mask = np.asarray(trainer.all_masks[en], np.float32)

    def classical(s) -> np.ndarray:
        rec = fbp(torch.as_tensor(s, device=dev)[None], theta, p, p, "ramp")[0]
        return crop_center(rec.cpu().numpy(), fx, fy)

    used = mask > _EPS
    partial_unnorm = np.where(used[:, None], partial / np.where(used, mask, 1.0)[:, None], 0.0)
    out.update({
        "ActualSinogramNoisy": actual_noisy.cpu().numpy(),
        "ComputedSinogram": computed.cpu().numpy(),
        "InputPartialSinogram": partial,
        "ReconFromActualSinogram": classical(actual_noisy),
        "ReconFromPVAE": recon_sample.cpu().numpy(),
        "ReconFromPVAEMean": aux.recon_mean[0].cpu().numpy(),
        "ReconFromInputPartialSinogram": classical(partial_unnorm.astype(np.float32)),
    })

    results = {}
    if not cfg.real_data and cfg.input_path:
        gt = data_io.load_ground_truth(cfg.input_path)[en]
        out["GroundTruth"] = gt
        print("Reconstruction from full sinogram:")
        results["full"] = compare(gt, np.clip(out["ReconFromActualSinogram"], 0, 1), verbose=True)
        print("Reconstruction from partial noisy sinogram")
        results["partial"] = compare(gt, np.clip(out["ReconFromInputPartialSinogram"], 0, 1),
                                     verbose=True)
        print("Reconstruction from P-VAE")
        results["pvae"] = compare(gt, out["ReconFromPVAE"], verbose=True)
        print("Reconstruction from P-VAE (posterior mean)")
        results["pvae_mean"] = compare(gt, out["ReconFromPVAEMean"], verbose=True)
    out["results"] = results
    return out


def write_panels(save_path: str, panels: Dict[str, object], num_sparse_angles: int) -> None:
    """The JAX package's PNGs of ``visualize_arrays``'s panels under ``save_path``."""
    plt = pyplot()
    os.makedirs(save_path, exist_ok=True)
    noisy = panels["ActualSinogramNoisy"]
    vmin, vmax = float(np.min(noisy)), float(np.max(noisy))
    ranges = {None: (None, None), "noisy": (vmin, vmax),
              "partial": (vmin, vmax / max(num_sparse_angles, 1))}
    for name, title, rng in PANELS:
        if name in panels:
            _plot(plt, save_path, name, panels[name], *ranges[rng], title=title)


def visualize_run(cfg: Config, trainer=None, device: DeviceLike = "cuda",
                  draws: Optional[Union[Draws, DrawSource]] = None) -> dict:
    """Produce the panel set under ``cfg.save_path``; returns the metric
    comparisons ("full", "partial", "pvae", "pvae_mean").  Builds the run's
    trainer from its latest checkpoint unless one is given.  Writing the
    PNGs needs matplotlib: without it this raises ``ImportError`` before
    any work (``visualize_arrays`` gives the numbers)."""
    from ..vi.train import Trainer

    if cfg.save_path:
        pyplot()
    exact_f32()
    if trainer is None:
        trainer = Trainer(cfg.replace(train=False, restore=True, use_latest_ckpt=True), device=device)
    panels = visualize_arrays(cfg, trainer, draws)
    if cfg.save_path:
        write_panels(cfg.save_path, panels, cfg.num_sparse_angles)
    return panels["results"]
