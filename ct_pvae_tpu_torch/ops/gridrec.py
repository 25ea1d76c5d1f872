"""Fourier-regridding reconstruction (port of ``ct_pvae_tpu/ops/gridrec.py``).

The gridrec algorithm class, as the JAX package writes it in XLA
(gridrec.py:54-253), here in plain torch:

  1. the 1-D DFT of each zero-padded, centre-referenced projection gives
     polar samples of the object's spectrum (central slice theorem);
  2. each sample, weighted by the band-limited ramp and its Voronoi angle
     cell, is spread onto a 2x-oversampled Cartesian lattice with a
     separable Kaiser-Bessel kernel: by 16 scatter-adds ("scatter") or by
     dense per-angle tables, one matrix product chain an angle ("matmul");
  3. an inverse 2-D FFT with a half-pixel-centre phase ramp, then division
     by the kernel's analytic transform (deapodisation) and a crop.

"auto" takes "matmul" unless its two (A, Pg, m) tables would pass 512 MB,
as the JAX package does for concrete angles (every angle set here is
concrete).

The sample positions and the spreading tables are the JAX package's float32
ones, computed on the CPU, so every device spreads with the same taps (a
sample within rounding of a lattice point takes the tap set on one side or
the other).  The spectrum, the lattice sums and the inverse FFT run in
float64 and the image is returned in float32.  In float32 the ramp lifts
the rounding of the projections' large low frequencies into the high ones,
and the card's spectrum and scatter-adds (whose order changes from run to
run) round differently from the CPU's: at the stretch geometry the two
devices' float32 reconstructions differed by more than 1e-5 of the image's
maximum.  In float64 they agree to float32 rounding of the output, and both
agree with the JAX package's float32 arithmetic to its rounding.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .fbp import fourier_filter, voronoi_angle_weights

TABLE_CAP_MB = 512  # "auto" scatters above this many MB of matmul tables


def _kb_beta(width: int, osf: int) -> float:
    """Beatty et al. (2005) Kaiser-Bessel shape for this grid."""
    return math.pi * math.sqrt((width / osf) ** 2 * (osf - 0.5) ** 2 - 0.8)


def _kb_kernel(s: torch.Tensor, width: int, beta: float) -> torch.Tensor:
    """Separable Kaiser-Bessel kernel of half-width ``width / 2`` lattice
    cells at the lattice offsets ``s``."""
    half = width / 2.0
    x = 1.0 - (s / half) ** 2
    val = torch.special.i0(beta * torch.sqrt(torch.clamp(x, min=0.0)))
    norm = torch.special.i0(torch.tensor(beta, dtype=s.dtype, device=s.device))
    return torch.where(x >= 0.0, val / norm, 0.0)


def _kb_apodization(x: np.ndarray, width: int, beta: float, m: int) -> np.ndarray:
    """The KB kernel's analytic Fourier transform at image offsets ``x``
    for an ``m``-point lattice: the deapodisation divisor."""
    half = width / 2.0
    arg = beta**2 - (2.0 * math.pi * half * x / m) ** 2
    rt = np.sqrt(np.abs(arg))
    a = np.where(arg > 0, np.sinh(rt) / np.maximum(rt, 1e-30), np.sinc(rt / math.pi))
    return (2.0 * half / np.i0(beta)) * a


def _spread_tables(theta_np: np.ndarray, pg: int, m: int, oversample: int,
                   kernel_width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Dense per-angle spreading tables (W_x, W_y), each (A, Pg, m): the KB
    weight with which polar sample (a, k) lands on lattice row or column j,
    taps wrapped mod m as the scatter method wraps them (gridrec.py:77-116)."""
    beta = _kb_beta(kernel_width, oversample)
    half = kernel_width / 2.0
    k = np.fft.fftfreq(pg) * pg

    def kb_np(s: np.ndarray) -> np.ndarray:
        x = 1.0 - (s / half) ** 2
        val = np.i0(beta * np.sqrt(np.maximum(x, 0.0)))
        return np.where(x >= 0.0, val / np.i0(beta), 0.0)

    offs = np.arange(kernel_width) - (kernel_width // 2 - 1)

    def table(g: np.ndarray) -> np.ndarray:
        ix0 = np.floor(g).astype(np.int64)
        w_tab = np.zeros((g.shape[0], pg, m), np.float32)
        aa = np.arange(g.shape[0])[:, None]
        kk = np.arange(pg)[None, :]
        for d in offs:
            np.add.at(w_tab, (aa, kk, np.mod(ix0 + d, m)), kb_np((ix0 + d) - g).astype(np.float32))
        return w_tab

    gx = k[None, :] * (oversample * -np.sin(theta_np))[:, None]
    gy = k[None, :] * (oversample * np.cos(theta_np))[:, None]
    return table(gx), table(gy)


@lru_cache(maxsize=8)
def _sample_positions(theta: Tuple[float, ...], pg: int, oversample: int,
                      device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Where each polar sample (a, k) lands on the lattice, (A * Pg,) each:
    g = k * osf * (-sin, cos) in lattice units, floor(g) - g and floor(g).
    Computed on the CPU in float32 and moved to ``device``, so that every
    device takes the same taps: a sample within rounding of a lattice point
    takes the tap set on one side or the other, which moves a kernel tail
    of 1/i0(beta) ~ 1e-3 of its mass.  Read-only (cached per geometry)."""
    th = torch.tensor(theta, dtype=torch.float32)
    k = torch.as_tensor(np.fft.fftfreq(pg) * pg, dtype=torch.float32)
    gx = k[None, :] * (oversample * -torch.sin(th))[:, None]   # (A, Pg)
    gy = k[None, :] * (oversample * torch.cos(th))[:, None]
    ix0, iy0 = torch.floor(gx), torch.floor(gy)
    return tuple(t.reshape(-1).to(device) for t in (ix0 - gx, iy0 - gy, ix0.long(), iy0.long()))


def gridrec(
    sinogram: torch.Tensor,
    theta,
    x_size: int,
    y_size: int,
    filter_name: str = "ramp",
    oversample: int = 2,
    kernel_width: int = 4,
    method: str = "auto",
) -> torch.Tensor:
    """Fourier-regridding reconstruction of ``sinogram`` (..., A, P) ->
    (..., x_size, y_size) in float32, with Voronoi angle weights built in;
    the signature of ``fbp``.  ``method``: "auto", "matmul" or "scatter"."""
    dev = sinogram.device
    f64, c128 = dict(dtype=torch.float64, device=dev), dict(dtype=torch.complex128, device=dev)
    a, p = sinogram.shape[-2], sinogram.shape[-1]
    batch_shape = sinogram.shape[:-2]
    sino = sinogram.reshape((-1, a, p)).float().double()  # float32 data, float64 arithmetic
    b = sino.shape[0]
    theta = torch.as_tensor(theta, dtype=torch.float32, device=dev).reshape(-1)

    pg = 1 << max(int(math.ceil(math.log2(max(p, 2)))), 1)   # padded detector
    m = oversample * pg                                       # lattice size
    beta = _kb_beta(kernel_width, oversample)

    # 1. polar spectrum samples: F1[a, k] = sum_t p[a, t] exp(-2 pi i k (t - ct) / pg)
    ct = (p - 1) / 2.0
    spec = torch.fft.fft(torch.nn.functional.pad(sino, (0, pg - p)), dim=-1)
    k_np = np.fft.fftfreq(pg) * pg
    spec = spec * torch.as_tensor(np.exp(2j * np.pi * k_np * ct / pg), **c128)
    # polar quadrature mass: Voronoi d_theta x the band-limited ramp / 2 x d_omega = 1/pg
    omega = torch.as_tensor(fourier_filter(pg, filter_name), **f64)
    dtheta = voronoi_angle_weights(theta).double()
    mass = spec * (dtheta[:, None] * (omega[None, :] * 0.5) / pg)   # (B, A, Pg)

    # 2. spread onto the oversampled lattice
    if method == "auto":
        method = "scatter" if 2 * a * pg * m * 4 / 2**20 > TABLE_CAP_MB else "matmul"
    if method == "matmul":
        wx_np, wy_np = _spread_tables(theta.cpu().numpy().astype(np.float64), pg, m, oversample,
                                      kernel_width)
        wx_t = torch.as_tensor(wx_np, **f64)
        wy_t = torch.as_tensor(wy_np, **f64)
        grid_r = torch.zeros((b, m, m), **f64)
        grid_i = torch.zeros((b, m, m), **f64)
        for q in range(a):
            # grid_b += W_x[q]^T @ diag(mass_b[q]) @ W_y[q]
            wxa, wya = wx_t[q], wy_t[q]
            grid_r += torch.einsum("km,bkn->bmn", wxa, mass.real[:, q, :, None] * wya[None])
            grid_i += torch.einsum("km,bkn->bmn", wxa, mass.imag[:, q, :, None] * wya[None])
        grid = torch.complex(grid_r, grid_i)
    elif method == "scatter":
        fx, fy, ix0f, iy0f = _sample_positions(tuple(theta.tolist()), pg, oversample, dev)
        fx, fy = fx.double(), fy.double()
        flat_r = mass.real.reshape(b, -1)
        flat_i = mass.imag.reshape(b, -1)
        grid_r = torch.zeros((b, m * m), **f64)
        grid_i = torch.zeros((b, m * m), **f64)
        offs = [d - (kernel_width // 2 - 1) for d in range(kernel_width)]
        for dx in offs:
            wx = _kb_kernel(fx + dx, kernel_width, beta)
            jx = torch.remainder(ix0f + dx, m)
            for dy in offs:
                wxy = wx * _kb_kernel(fy + dy, kernel_width, beta)
                idx = jx * m + torch.remainder(iy0f + dy, m)
                grid_r.index_add_(1, idx, flat_r * wxy)
                grid_i.index_add_(1, idx, flat_i * wxy)
        grid = torch.complex(grid_r, grid_i).reshape(b, m, m)
    else:
        raise ValueError(f"unknown method {method!r} (use 'auto'/'matmul'/'scatter')")

    # 3. inverse FFT with the -c phase ramp, deapodise, crop
    cx, cy = (x_size - 1) / 2.0, (y_size - 1) / 2.0
    km = np.fft.fftfreq(m) * m
    phase_x = torch.as_tensor(np.exp(-2j * np.pi * km * cx / m), **c128)
    phase_y = torch.as_tensor(np.exp(-2j * np.pi * km * cy / m), **c128)
    grid = grid * phase_x[None, :, None] * phase_y[None, None, :]
    img = torch.fft.ifft2(grid, dim=(-2, -1)) * (m * m)
    img = img[:, :x_size, :y_size].real
    apod_x = _kb_apodization(np.arange(x_size) - cx, kernel_width, beta, m)
    apod_y = _kb_apodization(np.arange(y_size) - cy, kernel_width, beta, m)
    img = img / torch.as_tensor(np.outer(apod_x, apod_y), **f64)
    return img.float().reshape(batch_shape + (x_size, y_size))
