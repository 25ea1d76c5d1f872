"""Projector geometry and the pixel-driven backprojector (port of ``ops/radon.py``).

Geometry convention shared with ``fbp.py`` and the Joseph projector:

  * image f[x, y], centred coordinates X = x - (H-1)/2, Y = y - (W-1)/2
  * a point (X, Y) hits detector coordinate t_hat = Y cos(theta) - X sin(theta)

Counterparts: ``num_proj_pixels`` and ``pad_phantom`` (radon.py:44-68) and the
chunked pixel-driven ``backproject`` (radon.py:232-304).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def num_proj_pixels(h: int, w: int) -> int:
    """Detector size for a padded projection of an (h, w) image:
    ceil((sqrt(h^2+w^2)+2)/2) * 2 (reference forward_functions.py:29-30)."""
    p = math.sqrt(h * h + w * w) + 2.0
    return int(math.ceil(p / 2.0) * 2)


def pad_phantom(phantom: torch.Tensor, n_det: Optional[int] = None) -> torch.Tensor:
    """Zero-pad the trailing two dims to (n_det, n_det): ``pad//2`` in front,
    the remainder at the back (reference forward_functions.py:32-44)."""
    h, w = phantom.shape[-2], phantom.shape[-1]
    if n_det is None:
        n_det = num_proj_pixels(h, w)
    padx, pady = n_det - h, n_det - w
    return F.pad(phantom, (pady // 2, pady - pady // 2, padx // 2, padx - padx // 2))


def backproject(
    sinogram: torch.Tensor,
    theta: torch.Tensor,
    x_size: int,
    y_size: int,
    angle_chunk: int = 32,
) -> torch.Tensor:
    """Pixel-driven (unfiltered) backprojection, (..., A, P) -> (..., x, y).

    Each output pixel linearly interpolates every angle's projection at
    t = Y cos(theta) - X sin(theta) + c_t with clamped edges, and sums over
    angles.  Angles are taken ``angle_chunk`` at a time (summed within a
    chunk, then across chunks, as the reference's scan does), which bounds
    the live (B, chunk, X, Y) gather.
    """
    a, p = sinogram.shape[-2], sinogram.shape[-1]
    batch_shape = sinogram.shape[:-2]
    sino = sinogram.reshape((-1, a, p)).float()
    b = sino.shape[0]
    dev = sino.device
    theta = torch.as_tensor(theta, dtype=torch.float32, device=dev)

    cx = (x_size - 1) / 2.0
    cy = (y_size - 1) / 2.0
    ct = (p - 1) / 2.0
    xg = (torch.arange(x_size, dtype=torch.float32, device=dev) - cx)[:, None]
    yg = (torch.arange(y_size, dtype=torch.float32, device=dev) - cy)[None, :]

    chunk = max(1, min(int(angle_chunk), a))
    out = torch.zeros((b, x_size, y_size), dtype=torch.float32, device=dev)
    for a0 in range(0, a, chunk):
        th = theta[a0 : a0 + chunk]
        sino_c = sino[:, a0 : a0 + chunk]                      # (B, c, P)
        cos = torch.cos(th)[:, None, None]
        sin = torch.sin(th)[:, None, None]
        t = yg[None] * cos - xg[None] * sin + ct               # (c, X, Y)
        t0 = torch.floor(t)
        wt = (t - t0).reshape(1, len(th), -1)
        i0 = t0.clamp(0, p - 1).long().reshape(1, len(th), -1).expand(b, -1, -1)
        i1 = (t0 + 1).clamp(0, p - 1).long().reshape(1, len(th), -1).expand(b, -1, -1)
        v0 = torch.gather(sino_c, 2, i0)
        v1 = torch.gather(sino_c, 2, i1)
        v = v0 * (1 - wt) + v1 * wt                            # (B, c, X*Y)
        out = out + v.sum(dim=1).reshape(b, x_size, y_size)
    return out.reshape(batch_shape + (x_size, y_size))
