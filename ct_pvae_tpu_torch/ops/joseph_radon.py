"""Joseph projector and its exact adjoint (port of ``ops/pallas_radon.py``, kernels A-D).

For a square (B, N, N) image and an (A, 5) table of per-angle rows
(slope_t, slope_r, offset, weight, is_y), the projection is

    out[b, a, t] = w_a * sum_r sum_y src[b, r, y] * max(0, 1 - |y - pos_a(r, t)|)
    pos_a(r, t)  = offset_a + slope_t_a * t + slope_r_a * r

with src the image, or its transpose where the row's flag is 1.  The JAX
package builds a dense (W, T) hat-weight tile per row for the TPU's matrix
unit (``_fwd_kernel_fused``, pallas_radon.py:455-484).  Each hat has only
two non-zeros per (row, detector): y0 = floor(pos) with weight 1-f and y0+1
with weight f; pixels outside [0, N) count as zero.  Both the CUDA kernels
and the plain versions here use that two-tap form.

  * kernel A, ``csrc/joseph_fwd.cu``: the forward over a traced angle subset
    (``_fwd_kernel_fused``);
  * kernel B, ``csrc/joseph_adj.cu``: its exact transpose
    (``_adj_kernel_fused``), the backward of the ``torch.autograd.Function``
    behind ``radon_fused``;
  * kernels C and D (``_fwd_kernel`` / ``_adj_kernel``, the static-angle pair
    behind ``radon_pallas`` / ``backproject_pallas``) are the same two CUDA
    entry points fed the full-angle table: there the row's flag does what the
    TPU code does by splitting the angles into two major-axis groups.
    ``radon_static`` / ``backproject_static`` count their launches apart.

A CUDA tensor goes through the kernels, a CPU tensor through the plain
versions; there is no fallback between the two.  ``LAUNCHES`` counts kernel
launches (never plain-version calls).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

# Kernel launches: A and B through ``radon_fused``, C and D through
# ``radon_static`` / ``backproject_static``.
LAUNCHES = {"joseph_fwd": 0, "joseph_adj": 0, "joseph_fwd_static": 0, "joseph_adj_static": 0}


def angle_table_fused(theta: np.ndarray, h: int, w: int, n_det: int) -> np.ndarray:
    """Static (A, 5) table: (slope_t, slope_r, offset, weight, is_y_major).

    An exact numpy copy of ``angle_table_fused`` (pallas_radon.py:420-452):
    row a holds the x-major scalars when |cos| >= |sin| (flag 0) and the
    y-major (transposed-image) scalars otherwise (flag 1).
    """
    if h != w:
        raise ValueError("fused projector requires square images")
    theta = np.asarray(theta, np.float64)
    c = np.cos(theta)
    s = np.sin(theta)
    cx = (h - 1) / 2.0
    cy = (w - 1) / 2.0
    ct = (n_det - 1) / 2.0
    x_major = np.abs(c) >= np.abs(s)

    safe_c = np.where(x_major, c, 1.0)
    safe_s = np.where(~x_major, s, 1.0)
    tab = np.stack(
        (
            np.where(x_major, 1.0 / safe_c, -1.0 / safe_s),
            np.where(x_major, s / safe_c, c / safe_s),
            np.where(
                x_major,
                cy - ct / safe_c - cx * (s / safe_c),
                cx + ct / safe_s - cy * (c / safe_s),
            ),
            np.where(x_major, 1.0 / np.abs(safe_c), 1.0 / np.abs(safe_s)),
            np.where(x_major, 0.0, 1.0),
        ),
        axis=-1,
    )
    return tab.astype(np.float32)


def _check_args(image: torch.Tensor, table: torch.Tensor, n_det: int) -> None:
    if image.dim() != 3 or image.shape[1] != image.shape[2]:
        raise ValueError(f"image must be (B, N, N), got {tuple(image.shape)}")
    if table.dim() != 2 or table.shape[1] != 5:
        raise ValueError(f"table must be (A, 5), got {tuple(table.shape)}")
    if image.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"float32 required, got {image.dtype} and {table.dtype}")
    if image.device != table.device:
        raise ValueError(f"image on {image.device} but table on {table.device}")
    if n_det < 1:
        raise ValueError(f"n_det must be positive, got {n_det}")


def radon_fused_plain(image: torch.Tensor, table: torch.Tensor, n_det: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, N, N) -> (B, A, n_det).

    The same two-tap arithmetic as ``csrc/joseph_fwd.cu``, vectorised over
    (B, A, T) and looped over image rows r.
    """
    _check_args(image, table, n_det)
    b, n, _ = image.shape
    dev = image.device
    slope_t, slope_r, offset, weight, flag = (table[:, i : i + 1] for i in range(5))
    is_y = (flag > 0.5)[None]                                  # (1, A, 1)
    t = torch.arange(n_det, dtype=torch.float32, device=dev)[None, :]
    base = offset + slope_t * t                                # (A, T)
    acc = torch.zeros((b, table.shape[0], n_det), dtype=torch.float32, device=dev)
    for r in range(n):
        pos = base + slope_r * float(r)                        # (A, T)
        y0 = torch.floor(pos)
        # rows of the straight image and of its transpose, picked per angle
        row = torch.where(is_y, image[:, None, :, r], image[:, None, r, :])  # (B, A, N)
        for yk in (y0, y0 + 1.0):
            hat = torch.clamp(1.0 - torch.abs(yk - pos), min=0.0)
            inside = (yk >= 0) & (yk <= n - 1)
            idx = yk.clamp(0, n - 1).long()[None].expand(b, -1, -1)
            tap = torch.gather(row, 2, idx)                    # (B, A, T)
            acc = acc + torch.where(inside[None], tap * hat[None], 0.0)
    return acc * weight[None]


def radon_fused_adjoint_plain(sino: torch.Tensor, table: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of the adjoint kernel: (B, A, T) -> (B, n, n).

    The exact transpose of ``radon_fused_plain``: the same taps, found the
    same way (loop over rows r, y0 = floor(pos) and y0 + 1), scattered into
    the straight image for x-major rows and into the transposed one for
    y-major rows.
    """
    if sino.dim() != 3 or table.shape != (sino.shape[1], 5):
        raise ValueError(f"bad shapes sinogram {tuple(sino.shape)} table {tuple(table.shape)}")
    if sino.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"float32 required, got {sino.dtype} and {table.dtype}")
    b, a, n_det = sino.shape
    dev = sino.device
    slope_t, slope_r, offset, weight, flag = (table[:, i : i + 1] for i in range(5))
    is_y = flag > 0.5                                          # (A, 1)
    t = torch.arange(n_det, dtype=torch.float32, device=dev)[None, :]
    base = offset + slope_t * t                                # (A, T)
    g = (sino * weight[None]).reshape(b, a * n_det)
    out = torch.zeros((b, n * n), dtype=torch.float32, device=dev)
    for r in range(n):
        pos = base + slope_r * float(r)
        y0 = torch.floor(pos)
        for yk in (y0, y0 + 1.0):
            hat = torch.clamp(1.0 - torch.abs(yk - pos), min=0.0)
            inside = (yk >= 0) & (yk <= n - 1)
            yi = yk.clamp(0, n - 1).long()
            pix = torch.where(is_y, yi * n + r, r * n + yi).reshape(-1)
            val = g * torch.where(inside, hat, 0.0).reshape(1, -1)
            out.index_add_(1, pix, val)
    return out.reshape(b, n, n)


def _forward(image: torch.Tensor, table: torch.Tensor, n_det: int, counter: str) -> torch.Tensor:
    if image.device.type == "cpu":
        return radon_fused_plain(image, table, n_det)
    from ._cuda import joseph_fwd

    out = joseph_fwd(image, table, n_det)  # checks its inputs; raises off CUDA
    LAUNCHES[counter] += 1
    return out


def _adjoint(sino: torch.Tensor, table: torch.Tensor, n: int, counter: str) -> torch.Tensor:
    if sino.device.type == "cpu":
        return radon_fused_adjoint_plain(sino, table, n)
    from ._cuda import joseph_adj

    out = joseph_adj(sino, table, n)
    LAUNCHES[counter] += 1
    return out


class _JosephProject(torch.autograd.Function):
    """Projection whose backward is the adjoint kernel (the custom VJP of
    ``radon_pallas_fused``, pallas_radon.py:619-628); the table gets no
    gradient."""

    @staticmethod
    def forward(ctx, image, table, n_det, counters):
        ctx.save_for_backward(table)
        ctx.n, ctx.adj_counter = image.shape[-1], counters[1]
        return _forward(image, table, n_det, counters[0])

    @staticmethod
    def backward(ctx, grad):
        (table,) = ctx.saved_tensors
        return _adjoint(grad.contiguous(), table, ctx.n, ctx.adj_counter), None, None, None


def radon_fused(image: torch.Tensor, table: torch.Tensor, n_det: int) -> torch.Tensor:
    """Fused Joseph projection (B, N, N) x (A, 5) -> (B, A, n_det), differentiable
    in the image: kernel A forward, kernel B backward."""
    _check_args(image, table, n_det)
    return _JosephProject.apply(image, table, n_det, ("joseph_fwd", "joseph_adj"))


def radon_fused_adjoint(sino: torch.Tensor, table: torch.Tensor, n: int) -> torch.Tensor:
    """Kernel B alone: the exact adjoint of ``radon_fused``, (B, A, T) -> (B, n, n)."""
    return _adjoint(sino, table, n, "joseph_adj")


@lru_cache(maxsize=16)
def static_table(theta: Tuple[float, ...], n: int, n_det: int, device: torch.device) -> torch.Tensor:
    """The full-angle fused table on ``device``, built once per geometry."""
    return torch.as_tensor(angle_table_fused(np.asarray(theta), n, n, n_det), device=device)


def radon_static(image: torch.Tensor, theta: Tuple[float, ...], n_det: int) -> torch.Tensor:
    """Static-angle Joseph projection (kernel C), the counterpart of
    ``radon_pallas`` (angles as a tuple, as there): (B, N, N) -> (B, A, n_det).
    Square images only."""
    if image.dim() != 3 or image.shape[1] != image.shape[2]:
        raise ValueError(f"radon_static takes square (B, N, N) images, got {tuple(image.shape)}")
    table = static_table(theta, image.shape[1], n_det, image.device)
    _check_args(image, table, n_det)
    return _JosephProject.apply(image, table, n_det, ("joseph_fwd_static", "joseph_adj_static"))


def backproject_static(sino: torch.Tensor, theta: Tuple[float, ...], h: int, w: int) -> torch.Tensor:
    """Static-angle adjoint (kernel D), the counterpart of ``backproject_pallas``:
    (B, A, n_det) -> (B, h, w), the exact transpose of ``radon_static``.
    Square images only."""
    if h != w:
        raise ValueError(f"backproject_static takes square images, got {h} x {w}")
    table = static_table(theta, h, sino.shape[-1], sino.device)
    return _adjoint(sino.contiguous(), table, h, "joseph_adj_static")
