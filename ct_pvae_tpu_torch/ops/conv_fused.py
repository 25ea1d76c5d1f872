"""Fused 3x3 periodic conv + bias + maxout (kernel E, port of the probe's Pallas kernel).

``conv3x3_periodic_maxout(x, kern, bias)`` takes an NHWC float32 input
(B, H, W, C), an HWIO kernel (3, 3, C, 2F) and a bias (2F,) and returns

    y   = conv_VALID(periodic_pad_1(x), kern) + bias        (B, H, W, 2F)
    out = max(y[..., :F], y[..., F:])                       (B, H, W, F)

what ``f_lax``, ``f_im2col`` and ``f_pallas`` compute in
``scripts/probe_conv_fused.py`` (:68-133), and what the JAX package's
``ConvBlock(features=F, kernel=3, stride=1)`` computes (models/pvae.py:194,
``_periodic_pad`` :40, ``_shrink_pad(H, 1, 3) == (1, 1)`` :45).  The layout
is the probe's NHWC, so the tests compare like with like.

  * kernel E, ``csrc/conv_fused_mma.cu``: the TPU kernel ``kernel``
    (probe_conv_fused.py:97) written for Hopper's tensor cores, an implicit
    GEMM held to float32 by a 3xTF32 split.  Forward only, like the TPU
    kernel: an input that requires grad raises rather than returning a
    result cut off from autograd.  Its first design, ``csrc/conv_fused.cu``
    (CUDA cores), stays bound as ``_cuda.conv_fused_maxout``, a yardstick
    that no path calls.
  * ``conv3x3_periodic_maxout_plain``: the same im2col math in plain torch
    (nine shifted slices of the wrapped input, one matmul, bias, maxout).

A CUDA tensor goes through the kernel, a CPU tensor through the plain
version; there is no fallback between the two.  ``LAUNCHES`` counts kernel
launches (never plain-version calls).  The model's convs stay on cuDNN.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

LAUNCHES = {"conv_fused_maxout": 0}


def _check_args(x: torch.Tensor, kern: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    if kern.dim() != 4 or kern.shape[:3] != (3, 3, c) or kern.shape[3] % 2 or kern.shape[3] < 2:
        raise ValueError(f"kern must be (3, 3, {c}, 2F), got {tuple(kern.shape)}")
    if bias.shape != (kern.shape[3],):
        raise ValueError(f"bias must be ({kern.shape[3]},), got {tuple(bias.shape)}")
    if {x.dtype, kern.dtype, bias.dtype} != {torch.float32}:
        raise TypeError(f"float32 required, got {x.dtype}, {kern.dtype}, {bias.dtype}")
    if not x.device == kern.device == bias.device:
        raise ValueError(f"tensors on several devices: {x.device}, {kern.device}, {bias.device}")
    if torch.is_grad_enabled() and (x.requires_grad or kern.requires_grad or bias.requires_grad):
        raise RuntimeError("conv3x3_periodic_maxout is forward only (kernel E has no backward, "
                           "as the TPU kernel has none); call it under torch.no_grad()")


def _periodic_pad_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Wrap-around pad of 1 on both spatial dims of an NHWC tensor (jnp.pad mode='wrap')."""
    x = torch.cat([x[:, -1:], x, x[:, :1]], dim=1)
    return torch.cat([x[:, :, -1:], x, x[:, :, :1]], dim=2)


def conv3x3_periodic_maxout_plain(x: torch.Tensor, kern: torch.Tensor,
                                  bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel E, as im2col: the nine shifted slices of
    the wrapped input concatenated in the kernel's (dy, dx, c) order, one
    (B*H*W, 9C) x (9C, 2F) matmul, the bias and the maxout of the halves."""
    b, h, w, c = x.shape
    f = kern.shape[-1] // 2
    xp = _periodic_pad_nhwc(x)
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)], dim=-1)
    y = (cols.reshape(b * h * w, 9 * c) @ kern.reshape(9 * c, 2 * f) + bias).reshape(b, h, w, 2 * f)
    return torch.maximum(y[..., :f], y[..., f:])


def conv3x3_periodic_maxout(x: torch.Tensor, kern: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Fused 3x3 periodic conv + bias + maxout, (B, H, W, C) -> (B, H, W, F):
    kernel E on CUDA tensors, the plain version on CPU tensors."""
    _check_args(x, kern, bias)
    if x.device.type == "cpu":
        return conv3x3_periodic_maxout_plain(x, kern, bias)
    from ._cuda import conv_fused_mma

    out = conv_fused_mma(x, kern, bias)  # checks its inputs; raises off CUDA
    LAUNCHES["conv_fused_maxout"] += 1
    return out


def maxout_params_from_flax(block: Mapping) -> Tuple[np.ndarray, np.ndarray]:
    """A flax ``ConvBlock``'s two branches (``Conv_0``, ``Conv_1``: HWIO
    kernels and biases) as E's (3, 3, C, 2F) kernel and (2F,) bias,
    concatenated on the output axis as ``ConvBlock`` runs them
    (models/pvae.py:224-233)."""
    kern = np.concatenate([np.asarray(block["Conv_0"]["kernel"]),
                           np.asarray(block["Conv_1"]["kernel"])], axis=-1)
    bias = np.concatenate([np.asarray(block["Conv_0"]["bias"]), np.asarray(block["Conv_1"]["bias"])])
    return kern.astype(np.float32), bias.astype(np.float32)
