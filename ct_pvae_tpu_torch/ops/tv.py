"""Chambolle-Pock TV reconstruction with an injected projector pair (port of
``ops/tv.py`` ``tv_with_ops``, ``_grad`` and ``_div``, tv.py:25-78).

Solves min_x 0.5 ||A x - p||^2 + lam TV(x) with the primal-dual scheme; a
Python loop takes the place of ``lax.scan``.  The classical-init stack runs
it on the static Joseph pair, kernels C and D.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

Op = Callable[[torch.Tensor], torch.Tensor]


def _grad(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward differences with the last row/column repeated (zero there)."""
    gx = torch.diff(x, dim=-2, append=x[..., -1:, :])
    gy = torch.diff(x, dim=-1, append=x[..., :, -1:])
    return gx, gy


def _div(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Discrete divergence, as tv.py:31-34."""
    dx = torch.cat([gx[..., :1, :], gx[..., 1:-1, :] - gx[..., :-2, :], -gx[..., -2:-1, :]], dim=-2)
    dy = torch.cat([gy[..., :, :1], gy[..., :, 1:-1] - gy[..., :, :-2], -gy[..., :, -2:-1]], dim=-1)
    return dx + dy


def tv_with_ops(
    sinogram: torch.Tensor,
    fwd: Op,
    adj: Op,
    x_size: int,
    y_size: int,
    num_iter: int = 50,
    lam: float = 0.05,
    sigma: float = 0.5,
    tau: float = 1e-3,
) -> torch.Tensor:
    """TV reconstruction (..., A, P) -> (..., x_size, y_size): num_iter
    applications of ``fwd`` and of ``adj``."""
    x = torch.zeros(sinogram.shape[:-2] + (x_size, y_size), dtype=sinogram.dtype,
                    device=sinogram.device)
    xbar = x
    y_fid = torch.zeros_like(sinogram)  # dual of the data term
    y_gx = torch.zeros_like(x)          # duals of the TV term
    y_gy = torch.zeros_like(x)
    for _ in range(num_iter):
        y_fid = (y_fid + sigma * (fwd(xbar) - sinogram)) / (1.0 + sigma)
        gx, gy = _grad(xbar)
        y_gx = y_gx + sigma * gx
        y_gy = y_gy + sigma * gy
        scale = torch.clamp(torch.sqrt(y_gx**2 + y_gy**2) / lam, min=1.0)
        y_gx = y_gx / scale
        y_gy = y_gy / scale
        x_new = torch.relu(x - tau * (adj(y_fid) - _div(y_gx, y_gy)))
        xbar = 2.0 * x_new - x
        x = x_new
    return x
