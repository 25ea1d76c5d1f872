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

The TPU has two kernel pairs because Pallas bakes static angles into a
kernel; on the card both pairs read their angles from device memory, so
one pair of CUDA kernels runs all four:

  * ``csrc/joseph_fwd_static.cu``: the forward, as kernel A (``radon_fused``
    over a traced angle subset, ``_fwd_kernel_fused``) and as kernel C
    (``radon_static`` on the full table, ``_fwd_kernel``);
  * ``csrc/joseph_adj_static.cu``: its exact transpose, as kernel B (the
    backward of ``radon_fused``, ``_adj_kernel_fused``) and as kernel D
    (``backproject_static`` and the backward of ``radon_static``,
    ``_adj_kernel``).

Both find each tap once for a chunk of batch images, read (A, 8) kernel
rows (``kernel_rows``: the table and 1/slope_t) in the caller's order, and
take their taps from one expression in ``csrc/joseph_tap.cuh``.  The
forward groups the rows by major axis itself, on the device.  The first
designs of A and B (``csrc/joseph_fwd.cu``, ``csrc/joseph_adj.cu``) stay
only as yardsticks for ``chip_smoke.py`` and the ``cuda`` tests.

A CUDA tensor goes through the kernels, a CPU tensor through the plain
versions; there is no fallback between the two.  ``LAUNCHES`` counts kernel
launches (never plain-version calls).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

# Kernel launches: A and B through ``radon_fused`` (and its backward), C
# and D through ``radon_static`` (and its backward) / ``backproject_static``.
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
    """(A, 8) float32 kernel rows, 32 bytes a row: the (A, 5) table,
    1/slope_t (computed in float64, rounded once) and two zeros."""
    table = np.asarray(table, np.float32)
    rows = np.zeros((len(table), 8), np.float32)
    rows[:, :5] = table
    rows[:, 5] = 1.0 / table[:, 0].astype(np.float64)
    return rows


def _check_args(image: torch.Tensor, table: torch.Tensor, n_det: int) -> None:
    if image.dim() != 3 or image.shape[1] != image.shape[2]:
        raise ValueError(f"image must be (B, N, N), got {tuple(image.shape)}")
    if table.dim() != 2 or table.shape[1] not in (5, 8):
        raise ValueError(f"table must be (A, 5), or (A, 8) kernel rows, got {tuple(table.shape)}")
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


def _forward(image: torch.Tensor, rows: torch.Tensor, n_det: int) -> torch.Tensor:
    if image.device.type == "cpu":
        return radon_fused_plain(image, rows[:, :5], n_det)
    from ._cuda import joseph_fwd_static

    out = joseph_fwd_static(image, rows, n_det)  # checks its inputs; raises off CUDA
    LAUNCHES["joseph_fwd"] += 1
    return out


def _adjoint(sino: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    if sino.device.type == "cpu":
        return radon_fused_adjoint_plain(sino, rows[:, :5], n)
    from ._cuda import joseph_adj_static

    out = joseph_adj_static(sino, rows, n)
    LAUNCHES["joseph_adj"] += 1
    return out


class _JosephProject(torch.autograd.Function):
    """Projection whose backward is the adjoint kernel (the custom VJP of
    ``radon_pallas_fused``, pallas_radon.py:619-628); the rows get no
    gradient."""

    @staticmethod
    def forward(ctx, image, rows, n_det):
        ctx.save_for_backward(rows)
        ctx.n = image.shape[-1]
        return _forward(image, rows, n_det)

    @staticmethod
    def backward(ctx, grad):
        (rows,) = ctx.saved_tensors
        return _adjoint(grad.contiguous(), rows, ctx.n), None, None


def radon_fused(image: torch.Tensor, table: torch.Tensor, n_det: int) -> torch.Tensor:
    """Fused Joseph projection (B, N, N) x (A, 8) -> (B, A, n_det), differentiable
    in the image: kernel A forward, kernel B backward.  ``table`` holds the
    (A, 8) kernel rows of the call's angles (``kernel_rows``), as the serve
    and train steps pass them; the kernels' wrappers refuse anything else.
    On a CPU tensor the (A, 5) table is also taken, since the plain versions
    read only its first five columns."""
    _check_args(image, table, n_det)
    return _JosephProject.apply(image, table, n_det)


def radon_fused_adjoint(sino: torch.Tensor, table: torch.Tensor, n: int) -> torch.Tensor:
    """Kernel B alone: the exact adjoint of ``radon_fused``, (B, A, T) -> (B, n, n);
    ``table`` as there."""
    return _adjoint(sino, table, n)


@lru_cache(maxsize=16)
def static_table(theta: Tuple[float, ...], n: int, n_det: int, device: torch.device) -> torch.Tensor:
    """The full-angle fused table on ``device``, built once per geometry."""
    return torch.as_tensor(angle_table_fused(np.asarray(theta), n, n, n_det), device=device)


@lru_cache(maxsize=16)
def static_rows(theta: Tuple[float, ...], n: int, n_det: int, device: torch.device) -> torch.Tensor:
    """``kernel_rows`` of the full-angle table on ``device`` (for kernels C
    and D), built once per geometry."""
    rows = kernel_rows(angle_table_fused(np.asarray(theta), n, n, n_det))
    return torch.as_tensor(rows, device=device)


def _static_forward(image: torch.Tensor, theta: Tuple[float, ...], n_det: int) -> torch.Tensor:
    n, dev = image.shape[-1], image.device
    if dev.type == "cpu":
        return radon_fused_plain(image, static_table(theta, n, n_det, dev), n_det)
    from ._cuda import joseph_fwd_static

    out = joseph_fwd_static(image, static_rows(theta, n, n_det, dev), n_det)
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
