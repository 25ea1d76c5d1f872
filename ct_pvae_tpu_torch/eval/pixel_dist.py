"""Per-pixel posterior histograms against the analytic toy posterior (port of
``ct_pvae_tpu/eval/pixel_dist.py``).

The reference's CT_VAE.pixel_dist (main_ct_vae.py:648-731), as the JAX
package writes it (pixel_dist.py:30-124): ``num_repeats`` eval steps on one
toy example tiled to the batch, each followed by ``num_samples_1`` draws of
the output distribution of its last ELBO sample, of which batch element 0
is kept; the draws' histogram per pixel beside the exact two-object
posterior (``mcmc/toy_model.py`` ``analytic_discrete_posterior``, on the
objects' sinograms from the gather ``radon``).

Only element 0 of each repeat is kept, and the eval step treats the
elements of its batch independently, so the port runs ``repeats_per_call``
repeats in one eval step, one copy of the example each: the reference's
10,000 repeats of 100 draws are ten eval steps of 1000 copies.
``repeats_per_call=None`` runs the JAX package's form, one eval step of
the batch per repeat.  Draws come from a ``torch.Generator`` seeded with
``seed`` (``PixelDraws``), the counterpart of ``PRNGKey(seed)``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.toy import X_TRAIN_0, X_TRAIN_1
from ..device import DeviceLike, exact_f32
from ..mcmc.toy_model import analytic_discrete_posterior
from ..ops.radon import radon
from ..prob.distributions import EPS, Beta, TruncatedNormal, draw_log_gamma
from ..vi.loss import GeneratorDraws
from .plots import pyplot


class PixelDraws:
    """The draws of ``collect_pixel_samples`` from one generator: per eval
    step, its latent and output draws (``eval_draws``), then the
    ``num_samples_1`` draws of the output distribution (``output``)."""

    def __init__(self, gen: torch.Generator, device: torch.device):
        self.gen, self.device = gen, device

    def eval_draws(self, first_repeat: int, num_repeats: int, batch: int):
        return GeneratorDraws(self.gen, self.device)

    def output(self, dist, first_repeat: int, num_repeats: int, num_samples_1: int) -> torch.Tensor:
        """(num_samples_1, B, x, y, 1) draws of ``dist``."""
        if isinstance(dist, TruncatedNormal):
            shape = (num_samples_1,) + tuple(dist.loc.shape)
            return dist.sample(EPS + (1.0 - 2.0 * EPS) * torch.rand(shape, generator=self.gen,
                                                                   device=self.device))
        shape = (num_samples_1,) + tuple(dist.a.shape)
        return dist.sample(draw_log_gamma(dist.a.expand(shape), self.gen),
                           draw_log_gamma(dist.b.expand(shape), self.gen))


def collect_pixel_samples(
    trainer,
    example_num: int,
    num_repeats: int = 1000,
    num_samples_1: int = 100,
    seed: int = 17,
    repeats_per_call: Optional[int] = 1000,
    draws=None,
) -> np.ndarray:
    """(num_repeats * num_samples_1, x*y) posterior draws for one example,
    repeat-major.  ``draws``: a ``PixelDraws``-like source (default: one
    seeded with ``seed`` on the trainer's device)."""
    cfg = trainer.cfg
    dev = trainer.device
    if draws is None:
        draws = PixelDraws(torch.Generator(device=dev).manual_seed(seed), dev)
    per_call = 1 if repeats_per_call is None else repeats_per_call
    out = []
    for r0 in range(0, num_repeats, per_call):
        n = min(per_call, num_repeats - r0)
        batch = cfg.batch_size if repeats_per_call is None else n
        idx = torch.full((batch,), example_num, dtype=torch.long, device=dev)
        _, aux = trainer.eval_step(idx, draws.eval_draws(r0, n, batch))
        loc, scale = aux.recon_params  # (batch, x, y, 1)
        dist = TruncatedNormal(loc, scale, 0.0, 1e10) if cfg.use_normal else Beta(loc, scale)
        sample = draws.output(dist, r0, n, num_samples_1)[:, :n, ..., 0]  # (S1, n, x, y)
        out.append(sample.transpose(0, 1).reshape(n, num_samples_1, -1).cpu().numpy())
    samples = np.concatenate(out, axis=0)
    return samples.reshape(-1, samples.shape[-1])


def toy_posterior(trainer, example_num: int, poisson_noise_multiplier: float) -> Tuple[float, float]:
    """The exact (P(O_0 | M), P(O_1 | M)) of the example's measurement, the
    objects' sinograms from the gather ``radon`` at the run's angles."""
    dev = trainer.device
    theta = torch.as_tensor(trainer.theta, device=dev)
    sino0 = radon(torch.as_tensor(X_TRAIN_0, device=dev), theta, pad=False)
    sino1 = radon(torch.as_tensor(X_TRAIN_1, device=dev), theta, pad=False)
    h0, h1 = analytic_discrete_posterior(
        torch.as_tensor(trainer.all_proj_samples[example_num], device=dev),
        torch.as_tensor(trainer.all_masks[example_num], device=dev),
        sino0, sino1, poisson_noise_multiplier)
    return float(h0), float(h1)


def plot_pixel_histograms(save_path: str, samples: np.ndarray, h0: float, h1: float,
                          example_num: int) -> None:
    """One ``pixel_vae_true_exp_{pix}_ex_{en}.png`` per pixel: the draws'
    histogram beside the two objects' posterior masses."""
    plt = pyplot()
    x0, x1 = X_TRAIN_0.reshape(-1), X_TRAIN_1.reshape(-1)
    delta_bin = 0.01
    bins = np.arange(5 * delta_bin / 10, 0.5 + delta_bin, delta_bin)
    for pix in range(samples.shape[1]):
        plt.figure(figsize=[10, 5])
        n, b = np.histogram(samples[:, pix], bins=bins, density=True)
        plt.bar((b[:-1] + b[1:]) / 2, n / n.sum(), width=0.01, label="P-VAE")
        plt.bar([x0[pix], x1[pix]], [h0, h1], width=delta_bin, edgecolor="black", alpha=0.2,
                hatch="//", label="True Posterior")
        plt.xlim([0, 0.5])
        plt.legend()
        plt.savefig(os.path.join(save_path, f"pixel_vae_true_exp_{pix}_ex_{example_num}.png"), dpi=150)
        plt.close()


def pixel_dist_run(
    cfg: Config,
    trainer=None,
    num_repeats: Optional[int] = None,
    num_samples_1: Optional[int] = None,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, Tuple[float, float]]:
    """Draws (cached as ``all_reconstructions_{en}.npy`` under
    ``cfg.save_path``), the analytic posterior and, with a save path, the
    histograms (matplotlib: without it this raises ``ImportError`` before
    any work).  Defaults to the reference scale, ``cfg.pixel_dist_repeats``
    x ``cfg.pixel_dist_samples_1`` (10,000 x 100).  Returns (samples, (h0, h1))."""
    from ..vi.train import Trainer

    save = cfg.save_path
    if save:
        pyplot()
    exact_f32()
    num_repeats = cfg.pixel_dist_repeats if num_repeats is None else num_repeats
    num_samples_1 = cfg.pixel_dist_samples_1 if num_samples_1 is None else num_samples_1
    if trainer is None:
        trainer = Trainer(cfg.replace(train=False, restore=True, use_latest_ckpt=True), device=device)
    en = cfg.example_num
    cache = os.path.join(save, f"all_reconstructions_{en}.npy") if save else None
    if cache and os.path.exists(cache):
        samples = np.load(cache)
    else:
        samples = collect_pixel_samples(trainer, en, num_repeats, num_samples_1)
        if cache:
            np.save(cache, samples)
    # the data were noised at cfg.poisson_noise_multiplier (the annealed pnm
    # starts at pnm_start)
    h0, h1 = toy_posterior(trainer, en, cfg.poisson_noise_multiplier)
    if save:
        plot_pixel_histograms(save, samples, h0, h1, en)
    return samples, (h0, h1)
