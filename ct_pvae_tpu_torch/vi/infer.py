"""Amortized posterior inference on new measurements (port of ``vi/infer.py``).

Loads a trained run's ``config.json`` and checkpoint, feeds new sinograms
through the measurement model and the classical-init stack, and emits
posterior summaries from ``num_passes`` independent latent draws per batch,
each an eval-mode ELBO pass with ``cfg.num_samples`` inner samples
(infer.py:47-152).  The request's outputs stay on the device until it
ends: a batch's moments accumulate over its passes in float32, its float64
finish (mean, clamped variance, std, as the reference's host arrays do)
runs there too, and the batch's rows of the mean, std and sample and its
loss are written into one float32 device buffer.  The batch loop never
waits for the card; after it, one synchronize (``ctpvae.infer.wait``) and
one copy of that buffer to the host, through a pinned block, into memory of
the call's own (``ctpvae.infer.readback``).  Each call
is a ``ctpvae.request`` span (``utils/trace.py``) around its stages' spans,
and ``timing`` holds the lengths of its ``ctpvae.setup`` and
``ctpvae.infer.batch`` spans; on a card a batch's span is the host's time
to enqueue its passes, not the card's time to run them.

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
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..data import io as data_io
from ..device import DeviceLike, exact_f32, resolve_device
from ..utils.trace import span
from .loss import DrawSource, Draws, GeneratorDraws
from .serve import Server

# sampler(batch_index, pass_index, latent_shapes, output_shape, num_samples)
#   -> Draws or a draw source
Sampler = Callable[[int, int, List[Tuple[int, ...]], Tuple[int, ...], int], Union[Draws, DrawSource]]


class TorchSampler:
    """Default draws: a seeded ``torch.Generator`` on the device as each
    step's draw source, drawing inside the step (latent normals, output
    uniforms, Beta's log-gamma variates)."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, batch_index, pass_index, latent_shapes, out_shape, num_samples):
        return GeneratorDraws(self.gen, self.device)


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

    Returns {"mean", "std", "sample", "loss"} as host arrays (views of one
    host array made by this call's readback), plus "timing", and writes the
    artifacts when ``output_path`` is set.  ``overrides``
    patches config fields for the new data (``real_data``,
    ``poisson_noise_multiplier``, ``cheap_init``).  Runs on ``device`` (CUDA
    unless the CPU is named) in exact float32.  ``sampler`` supplies the
    latent and output draws (default: a ``TorchSampler`` seeded ``seed + 7``).
    """
    with span("ctpvae.request"):
        dev = resolve_device(device)
        if num_passes < 1:
            raise ValueError(f"num_passes must be >= 1, got {num_passes}")
        exact_f32()
        with span("ctpvae.setup") as setup:
            with span("ctpvae.setup.config"):
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

        batch_s = []
        b = cfg.batch_size
        num_batches = -(-n // b)
        latent_shapes, out_shape = server.draw_shapes(b)
        maps = (n, server.x_size, server.y_size)
        size = n * server.x_size * server.y_size
        with span("ctpvae.infer.accumulators"):
            # mean, std, sample and the per-batch losses, read back as one copy
            outputs = torch.empty(3 * size + num_batches, dtype=torch.float32, device=dev)
            mean, std, sample = outputs[: 3 * size].view(3, *maps)
            losses = outputs[3 * size :]
            # a device divisor: CUDA multiplies by the reciprocal of a host scalar
            passes = torch.full((), float(num_passes), dtype=torch.float64, device=dev)
        for bi in range(num_batches):
            with span("ctpvae.infer.batch") as batch:
                # tail batch: clamp indices to n-1 and slice the duplicates off below
                bidx = torch.arange(bi * b, (bi + 1) * b, device=dev).clamp_(max=n - 1)
                rows = slice(bi * b, min((bi + 1) * b, n))
                take = rows.stop - rows.start
                ma = torch.zeros((b, server.x_size, server.y_size), device=dev)
                sa = torch.zeros_like(ma)
                loss_p = []
                for p in range(num_passes):
                    with span("ctpvae.infer.pass"):
                        draws = sampler(bi, p, latent_shapes, out_shape, cfg.num_samples)
                        loss, aux = server.eval_step(bidx, draws)
                        m = aux.recon_mean
                        ma += m
                        sa += m * m
                        if p == 0:
                            samp = aux.recon_sample
                        loss_p.append(loss)
                m64 = ma[:take].double() / passes
                var = (sa[:take].double() / passes - m64 * m64).clamp_(min=0.0)
                mean[rows] = m64
                std[rows] = var.sqrt_()
                sample[rows] = samp[:take]
                losses[bi] = torch.stack(loss_p).mean()
            batch_s.append(batch.seconds)
        with span("ctpvae.infer.wait"):  # the passes still queued on the card
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        with span("ctpvae.infer.readback"):
            # A copy from the card into fresh pageable memory faults its
            # pages in one at a time; a pinned block of PyTorch's host
            # allocator (cached from the second request on) takes the copy
            # at full speed, and the copy out of it faults the fresh pages
            # on all of PyTorch's CPU threads.
            staged = torch.empty(outputs.shape, dtype=outputs.dtype, pin_memory=dev.type == "cuda")
            staged.copy_(outputs)
            host = torch.empty(outputs.shape, dtype=outputs.dtype).copy_(staged).numpy()

        with span("ctpvae.infer.finish"):
            mean_h, std_h, sample_h = host[: 3 * size].reshape(3, *maps, 1)
            out = {
                "mean": mean_h,
                "std": std_h,
                "sample": sample_h,
                "loss": host[3 * size :],
                "timing": {"setup_s": setup.seconds, "batch_s": batch_s, "batch_size": b},
            }
        if output_path:
            np.save(os.path.join(output_path, "reconstruction_mean.npy"), out["mean"])
            np.save(os.path.join(output_path, "reconstruction_std.npy"), out["std"])
            np.save(os.path.join(output_path, "reconstruction_sample.npy"), out["sample"])
            np.save(os.path.join(output_path, "infer_loss.npy"), out["loss"])
            with open(os.path.join(output_path, "infer_timing.json"), "w") as f:
                json.dump(out["timing"], f)
    return out
