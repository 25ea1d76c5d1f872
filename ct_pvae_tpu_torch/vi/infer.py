"""Amortized posterior inference on new measurements (port of ``vi/infer.py``).

Loads a trained run's ``config.json`` and checkpoint, feeds new sinograms
through the measurement model and the classical-init stack, and emits
posterior summaries from ``num_passes`` independent latent draws per batch,
each an eval-mode ELBO pass with ``cfg.num_samples`` inner samples
(infer.py:47-152).  Per-batch moments accumulate in float32 on the device
and are added to float64 host accumulators.

Outputs under ``output_path``:
  reconstruction_mean.npy    (N, x, y, 1)  E[R] over passes x ELBO samples
  reconstruction_std.npy     (N, x, y, 1)  std of E[R|z] across latent draws
  reconstruction_sample.npy  (N, x, y, 1)  one draw (the reference's eval quirk)
  infer_loss.npy             (ceil(N/B),)  per-batch ELBO
  infer_timing.json          setup seconds and the wall seconds of each batch
plus the measurement and init artifacts (all_masks, all_proj_samples,
all_input_encode_cheap / all_input_encode) and config.json.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data import io as data_io
from ..device import DeviceLike, exact_f32, resolve_device
from .loss import Draws, standard_draws
from .serve import Server

# sampler(batch_index, pass_index, latent_shapes, output_shape, num_samples) -> Draws
Sampler = Callable[[int, int, List[Tuple[int, ...]], Tuple[int, ...], int], Draws]


class TorchSampler:
    """Default draws: standard normals and uniforms from a seeded
    ``torch.Generator`` on the device."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, batch_index, pass_index, latent_shapes, out_shape, num_samples) -> Draws:
        return standard_draws(self.gen, latent_shapes, out_shape, num_samples, self.device)


def amortized_infer(
    run_path: str,
    output_path: Optional[str],
    input_path: Optional[str] = None,
    sinograms: Optional[np.ndarray] = None,
    theta: Optional[np.ndarray] = None,
    num_passes: int = 8,
    ckpt_num: Optional[int] = None,
    overrides: Optional[dict] = None,
    seed: int = 0,
    device: DeviceLike = "cuda",
    sampler: Optional[Sampler] = None,
) -> dict:
    """Reconstruct new sinograms with the model trained at ``run_path``.

    Returns {"mean", "std", "sample", "loss"} as host arrays, plus "timing",
    and writes the artifacts when ``output_path`` is set.  ``overrides``
    patches config fields for the new data (``real_data``,
    ``poisson_noise_multiplier``, ``cheap_init``).  Runs on ``device`` (CUDA
    unless the CPU is named) in exact float32.  ``sampler`` supplies the
    latent and output draws (default: a ``TorchSampler`` seeded ``seed + 7``).
    """
    dev = resolve_device(device)
    if num_passes < 1:
        raise ValueError(f"num_passes must be >= 1, got {num_passes}")
    exact_f32()
    t_start = time.perf_counter()
    cfg = Config.load(os.path.join(run_path, "config.json"))
    if sinograms is None:
        if input_path is None:
            input_path = cfg.input_path
        sinograms, theta, _ = data_io.load_dataset(input_path)
    n = int(len(sinograms))
    cfg = cfg.replace(
        train=True,
        restore=False,
        save_path=output_path,
        input_path=input_path,
        truncate_dataset=n,
        seed=seed,
        **(overrides or {}),
    )
    server = Server(cfg, sinograms, theta, dev)
    server.restore(run_path, ckpt_num)
    if sampler is None:
        sampler = TorchSampler(cfg.seed + 7, dev)

    setup_s = time.perf_counter() - t_start
    batch_s = []
    b = cfg.batch_size
    num_batches = -(-n // b)
    latent_shapes, out_shape = server.draw_shapes(b)
    mean_acc = np.zeros((n, server.x_size, server.y_size), np.float64)
    sq_acc = np.zeros_like(mean_acc)
    sample = np.zeros((n, server.x_size, server.y_size), np.float32)
    losses = np.zeros(num_batches, np.float64)
    for bi in range(num_batches):
        t_batch = time.perf_counter()
        # tail batch: clamp indices to n-1 and slice the duplicates off below
        idx = np.minimum(np.arange(bi * b, (bi + 1) * b), n - 1)
        take = min(b, n - bi * b)
        bidx = torch.as_tensor(idx, device=dev)
        ma = torch.zeros((b, server.x_size, server.y_size), device=dev)
        sa = torch.zeros_like(ma)
        loss_p = []
        for p in range(num_passes):
            draws = sampler(bi, p, latent_shapes, out_shape, cfg.num_samples)
            loss, aux = server.eval_step(bidx, draws)
            m = aux.recon_mean
            ma += m
            sa += m * m
            if p == 0:
                samp = aux.recon_sample
            loss_p.append(loss)
        mean_acc[bi * b : bi * b + take] += ma.cpu().numpy()[:take]
        sq_acc[bi * b : bi * b + take] += sa.cpu().numpy()[:take]
        losses[bi] = float(torch.stack(loss_p).mean())
        sample[bi * b : bi * b + take] = samp.cpu().numpy()[:take]
        batch_s.append(time.perf_counter() - t_batch)  # the host copies above synchronise

    mean = (mean_acc / num_passes).astype(np.float32)
    var = np.maximum(sq_acc / num_passes - (mean_acc / num_passes) ** 2, 0.0)
    std = np.sqrt(var).astype(np.float32)
    out = {
        "mean": mean[..., None],
        "std": std[..., None],
        "sample": sample[..., None],
        "loss": losses.astype(np.float32),
        "timing": {"setup_s": setup_s, "batch_s": batch_s, "batch_size": b},
    }
    if output_path:
        np.save(os.path.join(output_path, "reconstruction_mean.npy"), out["mean"])
        np.save(os.path.join(output_path, "reconstruction_std.npy"), out["std"])
        np.save(os.path.join(output_path, "reconstruction_sample.npy"), out["sample"])
        np.save(os.path.join(output_path, "infer_loss.npy"), out["loss"])
        with open(os.path.join(output_path, "infer_timing.json"), "w") as f:
            json.dump(out["timing"], f)
    return out
