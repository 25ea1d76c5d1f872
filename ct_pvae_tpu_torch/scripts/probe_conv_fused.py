"""Bounded fused-conv probe on the GPU (port of ``scripts/probe_conv_fused.py``).

The heaviest conv class of the model is the stride-1 3x3 fused-maxout block
conv at full resolution (``ConvBlock``: periodic pad -> VALID conv to 2F
channels -> + bias -> max of the halves).  This probe runs it in three
formulations on the card, at the JAX probe's shapes, inputs and verdict:

  cudnn   the counterpart of the JAX probe's ``lax``: circular pad,
          ``F.conv2d`` (cuDNN, TF32 off), bias and maxout
  im2col  nine shifted slices concatenated to (B*H*W, 9C), one
          ``torch.matmul`` with (9C, 2F), bias and maxout: kernel E's plain
          version (``ops/conv_fused.py``)
  cuda    kernel E (``csrc/conv_fused_mma.cu``, tensor cores held to
          float32 by a 3xTF32 split), the counterpart of the JAX probe's
          ``pallas``

For each it prints the max relative error against ``cudnn`` (under 1e-4, as
in the JAX probe), the forward time with its TFLOP/s, and the fwd+bwd time
of the two library formulations; then the GO/NO-GO line at 1.3x against
``cudnn``.  Times are device time with the host held out: ``--iters`` calls
queued behind a spin kernel that outlasts their enqueue, the median of 5
such samples (``scripts/step_cost.py`` ``cuda_time``).  Kernel E's tile is
fixed in its source (16 x 16 pixels), so the JAX probe's ``--rows`` has no
counterpart.

Usage: python -m ct_pvae_tpu_torch.scripts.probe_conv_fused [--b 10] [--hw 128]
         [--cin 40] [--f 40] [--k 3] [--iters 50]

It needs a CUDA GPU and exits 1 without one.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import exact_f32
from ..ops.conv_fused import conv3x3_periodic_maxout, conv3x3_periodic_maxout_plain
from .step_cost import cuda_time

GO_THRESHOLD = 1.3
MAX_REL_ERR = 1e-4


def f_cudnn(x: torch.Tensor, kern: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Circular pad, ``F.conv2d`` in NCHW, bias and maxout; NHWC in and out."""
    f = kern.shape[-1] // 2
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="circular")
    y = F.conv2d(xp, kern.permute(3, 2, 0, 1), bias)
    return torch.maximum(y[:, :f], y[:, f:]).permute(0, 2, 3, 1)


FORMULATIONS: Dict[str, Callable] = {
    "cudnn": f_cudnn,
    "im2col": conv3x3_periodic_maxout_plain,
    "cuda": conv3x3_periodic_maxout,
}


def probe_inputs(b: int, hw: int, cin: int, f: int, k: int,
                 device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x, kern and bias drawn as the JAX probe draws them: one
    ``default_rng(0)``, x, then kern x 0.1, then bias x 0.1."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, hw, hw, cin)).astype(np.float32)
    kern = rng.normal(size=(k, k, cin, 2 * f)).astype(np.float32) * 0.1
    bias = rng.normal(size=(2 * f,)).astype(np.float32) * 0.1
    return tuple(torch.from_numpy(a).to(device) for a in (x, kern, bias))


def device_ms(fn: Callable[[], object], iters: int, repeats: int = 5) -> Tuple[float, str]:
    """Median over ``repeats`` samples of the device time per call of ``fn()``,
    each sample ``iters`` calls queued behind a spin kernel, with the host
    held out (``step_cost.cuda_time``); and a note for the printed line when
    the host's enqueue outlasted the spin (its time then holds host time)."""
    ms, _, covered = cuda_time(fn, repeats, per_sample=iters)
    return ms, "" if covered else "  (host in the window)"


def run(b: int = 10, hw: int = 128, cin: int = 40, f: int = 40, k: int = 3,
        iters: int = 50) -> None:
    """The probe on the current CUDA device; prints its lines and verdict."""
    if k != 3:
        raise ValueError("the probe is specialised to the model's 3x3 blocks (--k 3)")
    dev = torch.device("cuda")
    x, kern, bias = probe_inputs(b, hw, cin, f, k, dev)
    with torch.no_grad():
        ref = f_cudnn(x, kern, bias)
        for name in ("im2col", "cuda"):
            got = FORMULATIONS[name](x, kern, bias)
            err = float((got - ref).abs().max() / (ref.abs().max() + 1e-9))
            print(f"{name}: max rel err vs cudnn = {err:.2e}", flush=True)
            if not err < MAX_REL_ERR:
                raise AssertionError(f"{name} disagrees with cudnn: {err:.2e}")

        flops = 2 * b * hw * hw * k * k * cin * 2 * f
        ms = {}
        for name, fn in FORMULATIONS.items():
            ms[name], note = device_ms(lambda: fn(x, kern, bias), iters)
            print(f"{name:8s} {ms[name]:7.4f} ms  ({flops / ms[name] / 1e9:6.2f} TFLOP/s){note}",
                  flush=True)

    # fwd+bwd of the two library formulations (the train step is mostly backward)
    xg, kg = x.clone().requires_grad_(), kern.clone().requires_grad_()
    for name in ("cudnn", "im2col"):
        fn = FORMULATIONS[name]
        t, note = device_ms(lambda: torch.autograd.grad(fn(xg, kg, bias).sum(), (xg, kg)), iters)
        print(f"{name:8s} fwd+bwd {t:7.3f} ms{note}", flush=True)

    best = min(ms, key=ms.get)
    speedup = ms["cudnn"] / ms[best]
    verdict = "GO" if best != "cudnn" and speedup >= GO_THRESHOLD else "NO-GO"
    print(f"verdict: {verdict} — best={best} at {speedup:.2f}x vs cudnn "
          f"(threshold {GO_THRESHOLD}x)", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="probe_conv_fused", description=__doc__.splitlines()[0])
    ap.add_argument("--b", type=int, default=10)
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--cin", type=int, default=40)
    ap.add_argument("--f", type=int, default=40, help="maxout output channels")
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_conv_fused: torch.cuda.is_available() is False; the probe times kernel E "
              "and cuDNN on a CUDA GPU", file=sys.stderr)
        return 1
    exact_f32()
    print(f"device: {torch.cuda.get_device_name(0)}; B {args.b}, {args.hw}x{args.hw}, "
          f"C {args.cin} -> 2F {2 * args.f} -> F {args.f}", flush=True)
    run(args.b, args.hw, args.cin, args.f, args.k, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
