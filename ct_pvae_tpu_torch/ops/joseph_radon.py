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
  * kernel C, ``csrc/joseph_fwd_static.cu``: the static-angle forward
    (``_fwd_kernel``, behind ``radon_pallas``) on the full-angle table,
    behind ``radon_static``;
  * kernel D, ``csrc/joseph_adj_static.cu``: its exact transpose
    (``_adj_kernel``, behind ``backproject_pallas``), behind
    ``backproject_static`` and the backward of ``radon_static``.

On the full table the row's flag does what the TPU code does by splitting
the angles into two major-axis groups.  C and D find each tap once for a
chunk of batch images and read (A, 8) kernel rows (``kernel_rows``: the
table, 1/slope_t and the angle index; C's grouped by major axis,
``forward_rows``); their taps come from one expression in
``csrc/joseph_tap.cuh``.

A CUDA tensor goes through the kernels, a CPU tensor through the plain
versions; there is no fallback between the two.  ``LAUNCHES`` counts kernel
launches (never plain-version calls).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ._cuda import FWD_STATIC_ROWS_PER_BLOCK

# Kernel launches: A and B through ``radon_fused``, C and D through
# ``radon_static`` (and its backward) / ``backproject_static``.
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


def kernel_rows(table: np.ndarray) -> np.ndarray:
    """(A, 8) float32 rows of kernels C and D, 32 bytes a row: the (A, 5)
    table, 1/slope_t (computed in float64, rounded once), the row's angle
    index and a zero."""
    table = np.asarray(table, np.float32)
    rows = np.zeros((len(table), 8), np.float32)
    rows[:, :5] = table
    rows[:, 5] = 1.0 / table[:, 0].astype(np.float64)
    rows[:, 6] = np.arange(len(table))
    return rows


def forward_rows(rows: np.ndarray) -> np.ndarray:
    """Kernel C's rows: the x-major rows, then the y-major ones, each group
    padded to a multiple of ``FWD_STATIC_ROWS_PER_BLOCK`` with empty rows (angle index -1,
    weight 0, an offset that puts every tap off the image), so that a
    block's rows read one source, as the TPU code's two groups do."""
    parts = []
    for flag in (0.0, 1.0):
        group = rows[rows[:, 4] == flag]
        empty = np.zeros((-len(group) % FWD_STATIC_ROWS_PER_BLOCK, 8), np.float32)
        empty[:, [0, 2, 4, 5, 6]] = (1.0, -1e9, flag, 1.0, -1.0)
        parts += [group, empty]
    return np.concatenate(parts)


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


def _forward(image: torch.Tensor, table: torch.Tensor, n_det: int) -> torch.Tensor:
    if image.device.type == "cpu":
        return radon_fused_plain(image, table, n_det)
    from ._cuda import joseph_fwd

    out = joseph_fwd(image, table, n_det)  # checks its inputs; raises off CUDA
    LAUNCHES["joseph_fwd"] += 1
    return out


def _adjoint(sino: torch.Tensor, table: torch.Tensor, n: int) -> torch.Tensor:
    if sino.device.type == "cpu":
        return radon_fused_adjoint_plain(sino, table, n)
    from ._cuda import joseph_adj

    out = joseph_adj(sino, table, n)
    LAUNCHES["joseph_adj"] += 1
    return out


class _JosephProject(torch.autograd.Function):
    """Projection whose backward is the adjoint kernel (the custom VJP of
    ``radon_pallas_fused``, pallas_radon.py:619-628); the table gets no
    gradient."""

    @staticmethod
    def forward(ctx, image, table, n_det):
        ctx.save_for_backward(table)
        ctx.n = image.shape[-1]
        return _forward(image, table, n_det)

    @staticmethod
    def backward(ctx, grad):
        (table,) = ctx.saved_tensors
        return _adjoint(grad.contiguous(), table, ctx.n), None, None


def radon_fused(image: torch.Tensor, table: torch.Tensor, n_det: int) -> torch.Tensor:
    """Fused Joseph projection (B, N, N) x (A, 5) -> (B, A, n_det), differentiable
    in the image: kernel A forward, kernel B backward."""
    _check_args(image, table, n_det)
    return _JosephProject.apply(image, table, n_det)


def radon_fused_adjoint(sino: torch.Tensor, table: torch.Tensor, n: int) -> torch.Tensor:
    """Kernel B alone: the exact adjoint of ``radon_fused``, (B, A, T) -> (B, n, n)."""
    return _adjoint(sino, table, n)


@lru_cache(maxsize=16)
def static_table(theta: Tuple[float, ...], n: int, n_det: int, device: torch.device) -> torch.Tensor:
    """The full-angle fused table on ``device``, built once per geometry."""
    return torch.as_tensor(angle_table_fused(np.asarray(theta), n, n, n_det), device=device)


@lru_cache(maxsize=16)
def static_rows(theta: Tuple[float, ...], n: int, n_det: int, device: torch.device,
                forward: bool = False) -> torch.Tensor:
    """``kernel_rows`` of the full-angle table on ``device`` (for kernel D), or
    with ``forward`` its ``forward_rows`` (for kernel C), built once per
    geometry."""
    rows = kernel_rows(angle_table_fused(np.asarray(theta), n, n, n_det))
    return torch.as_tensor(forward_rows(rows) if forward else rows, device=device)


def _static_forward(image: torch.Tensor, theta: Tuple[float, ...], n_det: int) -> torch.Tensor:
    n, dev = image.shape[-1], image.device
    if dev.type == "cpu":
        return radon_fused_plain(image, static_table(theta, n, n_det, dev), n_det)
    from ._cuda import joseph_fwd_static

    out = joseph_fwd_static(image, static_rows(theta, n, n_det, dev, True), len(theta), n_det)
    LAUNCHES["joseph_fwd_static"] += 1
    return out


def _static_adjoint(sino: torch.Tensor, theta: Tuple[float, ...], n: int) -> torch.Tensor:
    n_det, dev = sino.shape[-1], sino.device
    if dev.type == "cpu":
        return radon_fused_adjoint_plain(sino, static_table(theta, n, n_det, dev), n)
    from ._cuda import joseph_adj_static

    out = joseph_adj_static(sino, static_rows(theta, n, n_det, dev), n)
    LAUNCHES["joseph_adj_static"] += 1
    return out


class _StaticProject(torch.autograd.Function):
    """Static-angle projection whose backward is kernel D (the custom VJP of
    ``radon_pallas``, pallas_radon.py:287-305)."""

    @staticmethod
    def forward(ctx, image, theta, n_det):
        ctx.theta, ctx.n = theta, image.shape[-1]
        return _static_forward(image, theta, n_det)

    @staticmethod
    def backward(ctx, grad):
        return _static_adjoint(grad.contiguous(), ctx.theta, ctx.n), None, None


def radon_static(image: torch.Tensor, theta: Tuple[float, ...], n_det: int) -> torch.Tensor:
    """Static-angle Joseph projection (kernel C), the counterpart of
    ``radon_pallas`` (angles as a tuple, as there): (B, N, N) -> (B, A, n_det).
    Square images only; differentiable in the image (kernel D backward)."""
    if image.dim() != 3 or image.shape[1] != image.shape[2]:
        raise ValueError(f"radon_static takes square (B, N, N) images, got {tuple(image.shape)}")
    if image.dtype != torch.float32:
        raise TypeError(f"float32 required, got {image.dtype}")
    if n_det < 1:
        raise ValueError(f"n_det must be positive, got {n_det}")
    return _StaticProject.apply(image, theta, n_det)


def backproject_static(sino: torch.Tensor, theta: Tuple[float, ...], h: int, w: int) -> torch.Tensor:
    """Static-angle adjoint (kernel D), the counterpart of ``backproject_pallas``:
    (B, A, n_det) -> (B, h, w), the exact transpose of ``radon_static``.
    Square images only."""
    if h != w:
        raise ValueError(f"backproject_static takes square images, got {h} x {w}")
    return _static_adjoint(sino.contiguous(), theta, h)
