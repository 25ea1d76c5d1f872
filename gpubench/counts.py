"""The benchmark's yardstick: peaks, model FLOPs and Joseph launch costs.

Frozen here so that no change to the program moves them.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense):
495 TFLOP/s of TF32 tensor-core work, used for every float32 share (any
correct float32 formulation may run on the tensor cores, as 3xTF32 does),
and 3.35 TB/s of HBM.

Model FLOPs count the convolutions as direct convolution, 2 x MACs: a
forward conv's MACs are out_h out_w C_in C_out k k, a transposed conv's
in_h in_w C_in C_out k k (C_out counts both maxout branches).  A training
step counts each conv three times (forward, input gradient, weight
gradient), except the input gradient of the encoder's first conv, which
nothing needs; the encoder runs on the batch, the decoder on the batch times
the ELBO samples.  An eval pass counts the forward only.

A Joseph application (kernels A-D), as PERF.md section 6 counts a launch:
bytes are the input, the (A, 5) angle rows and the output, each once, in
float32; operations are a multiply-add (2 flops) per in-range tap and one
weight scale per ray.  Its bound is the larger of bytes / HBM rate and flops
/ peak.  A roofline share sums the bounds of the applications that the
traced units of work need (``joseph_bound``), however the program launches
them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from .reference.projector import angle_table, joseph_taps
from .reference.pvae import Sizes

PEAK_FLOPS = 495e12       # TF32 tensor cores, FLOP/s
PEAK_BYTES = 3.35e12      # HBM, bytes/s


def _conv_macs(sizes: Sizes) -> Dict[str, list]:
    """MACs per image of each encoder and decoder conv, in block order."""
    enc, side = [], sizes.x
    for blk in sizes.encoder:
        out = -(-side // blk.stride)
        enc.append(out * out * blk.in_ch * 2 * blk.features * blk.kernel ** 2)
        side = out
    dec, side, level = [], sizes.levels[-1][0], len(sizes.levels) - 1
    macs = lambda blk, side: side * side * blk.in_ch * 2 * blk.features * blk.kernel ** 2
    for blk in sizes.decoder[:-1]:
        if blk.transpose:  # from the previous level, cropped to its size; the
            side = sizes.levels[level][0]  # level's blocks then run at stride x side
            level -= 1
            dec.append(macs(blk, side))
            side *= blk.stride
        else:
            dec.append(macs(blk, side))
    dec.append(macs(sizes.decoder[-1], sizes.x))  # the head, after the last crop
    return {"encoder": enc, "decoder": dec}


def train_step_flops(sizes: Sizes, batch: int, samples: int) -> int:
    macs = _conv_macs(sizes)
    enc = sum(macs["encoder"]) * 3 - macs["encoder"][0]
    dec = sum(macs["decoder"]) * 3
    return 2 * (batch * enc + batch * samples * dec)


def eval_pass_flops(sizes: Sizes, batch: int, samples: int) -> int:
    macs = _conv_macs(sizes)
    return 2 * (batch * sum(macs["encoder"]) + batch * samples * sum(macs["decoder"]))


def joseph_taps_per_image(theta: Sequence[float], n: int, n_det: int,
                          device: torch.device = torch.device("cpu")) -> int:
    table = torch.as_tensor(angle_table(np.asarray(theta, np.float32), n, n_det), device=device)
    return joseph_taps(table, n, n_det, count_only=True)


def joseph_cost(batch: int, n: int, n_angles: int, n_det: int, taps_per_image: float):
    """(bytes, flops) of one Joseph launch on ``batch`` n x n images and
    ``n_angles`` x ``n_det`` sinograms (either direction)."""
    nbytes = (batch * n * n + n_angles * 5 + batch * n_angles * n_det) * 4
    flops = 2 * taps_per_image * batch + batch * n_angles * n_det
    return nbytes, flops


def bound_seconds(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS)


def init_applications(algorithms: Sequence[str], p: int) -> Tuple[int, int]:
    """(forward, adjoint) Joseph applications on one scan's P x P image that
    its init stack needs (``reference.projector.init_stack``): sirt 30
    iterations and its row and column sums, tv 60 iterations, and from 512
    bins on each FBP channel's and the mask's backprojection (pixel-driven
    below 512)."""
    fwd = adj = 0
    for alg in algorithms:
        if alg == "sirt":
            fwd, adj = fwd + 31, adj + 31
        elif alg == "tv":
            fwd, adj = fwd + 60, adj + 60
        elif p >= 512:
            adj += 1
    return fwd, adj + (1 if p >= 512 else 0)


def joseph_bound(uses: Iterable[Tuple[int, int, int, int, int]], theta: Sequence[float],
                 device: torch.device = torch.device("cpu")) -> float:
    """Roofline seconds of ``uses``: (count, images, n, angles, bins), each
    ``count`` applications to ``images`` n x n images at ``angles`` of
    ``theta``'s angles (taps at the average per angle) onto ``bins`` bins."""
    total, taps = 0.0, {}
    for count, images, n, angles, bins in uses:
        if (n, bins) not in taps:
            taps[n, bins] = joseph_taps_per_image(theta, n, bins, device) / len(theta)
        nbytes, flops = joseph_cost(images, n, angles, bins, taps[n, bins] * angles)
        total += count * bound_seconds(nbytes, flops)
    return total
