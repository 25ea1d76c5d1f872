"""Fused Joseph forward projector (port of ``ops/pallas_radon.py``, kernel A).

For a square (B, N, N) image and an (A_sub, 5) table of per-angle rows
(slope_t, slope_r, offset, weight, is_y), the projection is

    out[b, a, t] = w_a * sum_r sum_y src[b, r, y] * max(0, 1 - |y - pos_a(r, t)|)
    pos_a(r, t)  = offset_a + slope_t_a * t + slope_r_a * r

with src the image, or its transpose where the row's flag is 1.  The JAX
package builds a dense (W, T) hat-weight tile per row for the TPU's matrix
unit (``_fwd_kernel_fused``, pallas_radon.py:455-484).  Each hat has only
two non-zeros per (row, detector): y0 = floor(pos) with weight 1-f and y0+1
with weight f; pixels outside [0, N) count as zero.  Both the CUDA kernel
(``csrc/joseph_fwd.cu``) and the plain version here use that two-tap form.

``radon_fused`` launches the CUDA kernel for a CUDA tensor and runs the plain
version only for a CPU tensor.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

# Kernel launches made by ``radon_fused`` (never by the plain version).
LAUNCHES = {"joseph_fwd": 0}


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


def radon_fused(image: torch.Tensor, table: torch.Tensor, n_det: int) -> torch.Tensor:
    """Fused Joseph projection (B, N, N) x (A, 5) -> (B, A, n_det).

    A CUDA tensor goes through the hand-written kernel, a CPU tensor through
    the plain version.  There is no fallback between the two.
    """
    if image.device.type == "cpu":
        return radon_fused_plain(image, table, n_det)
    from ._cuda import joseph_fwd

    out = joseph_fwd(image, table, n_det)  # checks its inputs; raises off CUDA
    LAUNCHES["joseph_fwd"] += 1
    return out
