"""Dataset-wide merit, the final_merit stage (port of ``ct_pvae_tpu/eval/merit.py``).

Against the ground truth, over every example of a run (reference
bin/final_merit.py; merit.py:28-163): (0) the classical reconstruction of
the Poisson-noised FULL sinogram, the upper bound; (1) that of the noisy
PARTIAL sinogram from its measured angles only, un-normalised by the mask,
the classical baseline; (2) the P-VAE reconstruction.  Rows 0 and 1 are
cropped to the recon size and clipped to [0, 1]; row 2 is scored as it is.
``baseline_alg`` picks the classical algorithm: "fbp" (the ramp FBP every
committed artifact was scored with) or "gridrec" (Fourier regridding,
``ops/gridrec.py``; saved under a suffixed name).

The reconstructions run on ``device``: the full sinograms through ``fbp``'s
route (kernel D on the card from 512 detector pixels up, the gather
backprojector below), the partial ones through the gather backprojector,
each example at its own measured angles.  The re-noising draws from a
``torch.Generator`` seeded with ``seed``, as the JAX package draws from
``PRNGKey(seed)``: the same distribution, not the same numbers.  Chunks
are not padded to ``batch`` (the JAX package pads to keep its jit shapes
fixed); every example is reconstructed on its own either way.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..data.masks import poisson_measurements
from ..data.recon_init import crop_center
from ..device import DeviceLike, exact_f32, resolve_device
from ..ops.fbp import fbp
from ..ops.gridrec import gridrec
from .metrics import compare

BASELINES = ("fbp", "gridrec")
ROW_LABELS = ("noisy, full sinogram", "noisy, partial sinogram", "P-VAE from noisy, partial sinogram")


def _classical(baseline_alg: str, s: torch.Tensor, theta, p: int) -> torch.Tensor:
    """Ramp reconstruction of (B, A, P) sinograms at (A,) or per-example (B, A) angles."""
    if baseline_alg == "fbp":
        return fbp(s, theta, p, p, "ramp")
    if torch.as_tensor(theta).dim() == 1:
        return gridrec(s, theta, p, p, "ramp")
    return torch.stack([gridrec(s[i], theta[i], p, p, "ramp") for i in range(s.shape[0])])


def measured_angles(all_masks: np.ndarray, all_proj_samples: np.ndarray, theta: np.ndarray):
    """(sinograms (N, nsa, P) of the measured angles, un-normalised by the
    mask; their angles (N, nsa)), as merit.py:69-83."""
    eps = float(np.finfo(np.float32).eps)
    masks = np.asarray(all_masks, np.float32)
    partial = np.asarray(all_proj_samples, np.float32)
    used_idx = [np.nonzero(m > eps)[0] for m in masks]
    if any(len(u) != len(used_idx[0]) for u in used_idx):
        raise ValueError("per-example measured-angle counts differ")
    used_idx = np.stack(used_idx)
    theta_used = np.asarray(theta, np.float32)[used_idx]
    sino_used = np.take_along_axis(partial, used_idx[:, :, None], axis=1)
    mask_used = np.take_along_axis(masks, used_idx, axis=1)
    return sino_used / mask_used[:, :, None], theta_used


def merit_recons(
    x_train_sinograms: np.ndarray,
    all_masks: np.ndarray,
    all_proj_samples: np.ndarray,
    theta: np.ndarray,
    poisson_noise_multiplier: float,
    x_size: int,
    y_size: int,
    seed: int = 0,
    batch: int = 32,
    baseline_alg: str = "fbp",
    device: DeviceLike = "cuda",
):
    """The classical rows' reconstructions, (recon0, recon1), each (N, x, y)
    on the host, cropped and clipped to [0, 1], N = len(all_masks)."""
    if baseline_alg not in BASELINES:
        raise ValueError(f"unknown baseline_alg {baseline_alg!r}")
    dev = resolve_device(device)
    n = len(all_masks)
    sinos = torch.as_tensor(np.asarray(x_train_sinograms[:n], np.float32), device=dev)
    p = sinos.shape[-1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    noisy_full = poisson_measurements(sinos, poisson_noise_multiplier, gen)
    sino_used, theta_used = measured_angles(all_masks, all_proj_samples, theta)
    theta_np = np.asarray(theta, np.float32)  # host angles: D's route reads them without a sync

    def run(arr: torch.Tensor, thetas=None) -> np.ndarray:
        outs = []
        for i in range(0, n, batch):
            th = theta_np if thetas is None else torch.as_tensor(thetas[i:i + batch], device=dev)
            outs.append(_classical(baseline_alg, arr[i:i + batch], th, p).cpu().numpy())
        return np.clip(crop_center(np.concatenate(outs, 0), x_size, y_size), 0.0, 1.0)

    recon0 = run(noisy_full)
    recon1 = run(torch.as_tensor(sino_used, device=dev), theta_used)
    return recon0, recon1


def final_merit(
    ground_truth: np.ndarray,          # (N, H, W)
    x_train_sinograms: np.ndarray,     # (N, A, P)
    all_masks: np.ndarray,             # (N, A)
    all_proj_samples: np.ndarray,      # (N, A, P)
    reconstruction_final: np.ndarray,  # (N, x, y) or (N, x, y, 1)
    theta: np.ndarray,
    poisson_noise_multiplier: float,
    save_path: Optional[str] = None,
    seed: int = 0,
    batch: int = 32,
    reconstruction_mean: Optional[np.ndarray] = None,
    baseline_alg: str = "fbp",
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """final_ave_merit (3, 3): rows (full-sinogram, partial-sinogram, P-VAE),
    columns (MSE, SSIM, PSNR), each the mean over the examples; saved as
    ``final_ave_merit.npy`` (``final_ave_merit_gridrec.npy`` for gridrec).
    ``reconstruction_mean``: the posterior mean, scored as an extra row
    saved to ``final_ave_merit_mean.npy``."""
    exact_f32()
    if reconstruction_final.ndim == 4:
        reconstruction_final = reconstruction_final[..., 0]
    n, x_size, y_size = reconstruction_final.shape
    gt = np.asarray(ground_truth[:n], np.float32)
    recon0, recon1 = merit_recons(
        x_train_sinograms, all_masks[:n], all_proj_samples[:n], theta, poisson_noise_multiplier,
        x_size, y_size, seed=seed, batch=batch, baseline_alg=baseline_alg, device=device)
    recon2 = np.asarray(reconstruction_final)  # unclipped (reference final_merit.py:42)

    def mean_row(recon) -> np.ndarray:
        return np.stack([compare(gt[i], recon[i]) for i in range(n)], axis=0).mean(axis=0)

    final_ave_merit = np.stack([mean_row(r) for r in (recon0, recon1, recon2)], axis=0)
    print("MSE, SSIM, PSNR")
    for label, row in zip(ROW_LABELS, final_ave_merit):
        print(label)
        print(row)
    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
        suffix = "" if baseline_alg == "fbp" else f"_{baseline_alg}"
        np.save(os.path.join(save_path, f"final_ave_merit{suffix}.npy"), final_ave_merit)

    if reconstruction_mean is not None:
        if reconstruction_mean.ndim == 4:
            reconstruction_mean = reconstruction_mean[..., 0]
        row = mean_row(np.asarray(reconstruction_mean, np.float32))
        print("P-VAE posterior mean (no sampling speckle)")
        print(row)
        if save_path is not None:
            np.save(os.path.join(save_path, "final_ave_merit_mean.npy"), row)
    return final_ave_merit
