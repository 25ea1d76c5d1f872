"""Filtered back-projection (port of ``ct_pvae_tpu/ops/fbp.py``).

rFFT filter multiply on the detector axis, then a backprojection, with the
classical uniform pi/(2A) angle weight or the Voronoi angle weights
(``fbp.py:25-168``).  This is what the init stack runs: the 'gridrec'
(ramp) and 'fbp' (shepp-logan) channels and the unfiltered mask channel.

The backprojection is routed as the JAX package routes it
(``_backproject_any``, fbp.py:25-47): a square reconstruction from a
detector of 512 pixels or more, at one (A,) angle set shared by the batch,
goes to the static Joseph adjoint (``backproject_static``, kernel D) on the
card, where the JAX package takes its Pallas adjoint on a TPU; per-example
angles (an (N, A) theta, which the JAX package meets as traced angles under
``vmap``), everything else and every CPU tensor go to the pixel-driven
gather ``backproject`` of ``radon.py``, as the JAX package does off the TPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .joseph_radon import backproject_static
from .radon import backproject

FILTERS = ("ramp", "ramlak", "shepp", "shepp-logan", "cosine", "hamming", "hann", "none")
KERNEL_DETECTOR = 512  # detectors from this size on take kernel D on the card


def kernel_d_route(theta, n_det: int, x_size: int, y_size: int, device: torch.device) -> bool:
    """Whether the backprojection takes kernel D: a square output from a
    detector of ``KERNEL_DETECTOR`` pixels or more on the card, at one (A,)
    angle set (D backprojects its whole batch through one angle set, so
    per-example (..., A) angles take the gather route)."""
    return (device.type == "cuda" and n_det >= KERNEL_DETECTOR and x_size == y_size
            and torch.as_tensor(theta).dim() == 1)


def _backproject_any(filtered: torch.Tensor, theta, x_size: int, y_size: int) -> torch.Tensor:
    """Kernel D where ``kernel_d_route`` says so, the gather ``backproject`` otherwise."""
    if kernel_d_route(theta, filtered.shape[-1], x_size, y_size, filtered.device):
        theta_t = tuple(float(t) for t in np.asarray(torch.as_tensor(theta).cpu(), np.float32))
        flat = filtered.reshape((-1,) + filtered.shape[-2:]).float()
        out = backproject_static(flat, theta_t, x_size, y_size)
        return out.reshape(filtered.shape[:-2] + (x_size, y_size))
    return backproject(filtered, theta, x_size, y_size)


def fourier_filter(size: int, filter_name: str = "ramp") -> np.ndarray:
    """Frequency-domain FBP filter of length ``size`` (full FFT layout):
    Kak & Slaney's band-limited ramp, optionally windowed."""
    if filter_name not in FILTERS:
        raise ValueError(f"unknown filter {filter_name!r}; options: {FILTERS}")
    f = np.zeros(size)
    f[0] = 0.25
    m_pos = np.arange(1, size // 2 + 1)
    odd_pos = m_pos[m_pos % 2 == 1]
    f[odd_pos] = -1.0 / (np.pi * odd_pos) ** 2
    m_neg = np.arange(1, (size + 1) // 2)
    odd_neg = m_neg[m_neg % 2 == 1]
    f[size - odd_neg] = -1.0 / (np.pi * odd_neg) ** 2
    omega = 2.0 * np.real(np.fft.fft(f))  # ~ 2|fftfreq|: ramp, 1 at Nyquist

    if filter_name in ("ramp", "ramlak"):
        pass
    elif filter_name in ("shepp", "shepp-logan"):
        w = np.pi * np.fft.fftfreq(size)[1:]
        omega[1:] *= np.sin(w) / w
    elif filter_name == "cosine":
        freq = np.linspace(0, np.pi, size, endpoint=False)
        omega *= np.fft.fftshift(np.sin(freq))
    elif filter_name == "hamming":
        omega *= np.fft.fftshift(np.hamming(size))
    elif filter_name == "hann":
        omega *= np.fft.fftshift(np.hanning(size))
    elif filter_name == "none":
        omega = np.ones(size)
    return omega


def filter_sinogram(sinogram: torch.Tensor, filter_name: str = "ramp") -> torch.Tensor:
    """Apply the FBP frequency filter along the detector axis via rFFT."""
    p = sinogram.shape[-1]
    omega = fourier_filter(p, filter_name)
    omega_r = torch.as_tensor(
        omega[: p // 2 + 1], dtype=torch.float32, device=sinogram.device
    )
    spec = torch.fft.rfft(sinogram, dim=-1)
    return torch.fft.irfft(spec * omega_r, n=p, dim=-1).to(sinogram.dtype)


def voronoi_angle_weights(theta: torch.Tensor) -> torch.Tensor:
    """Per-angle Voronoi cell lengths on the half-circle [0, pi), wrapping
    at the pi seam (fbp.py:101-131): pi/A each on a uniform grid.  Angles in
    radians with a span below pi; negative gaps are clamped to 0."""
    order = torch.argsort(theta, dim=-1, stable=True)
    ts = torch.take_along_dim(theta, order, dim=-1)
    gaps = torch.diff(ts, dim=-1)
    wrap = (ts[..., :1] + math.pi) - ts[..., -1:]     # gap across the pi seam
    g = torch.clamp(torch.cat([gaps, wrap], dim=-1), min=0.0)  # g[i] = ts[i+1] - ts[i]
    w_sorted = 0.5 * (g + torch.roll(g, 1, dims=-1))  # Voronoi cell of ts[i]
    inv = torch.argsort(order, dim=-1, stable=True)
    return torch.take_along_dim(w_sorted, inv, dim=-1).to(theta.dtype)


def fbp(
    sinogram: torch.Tensor,
    theta: torch.Tensor,
    x_size: int,
    y_size: int,
    filter_name: str = "ramp",
    angle_weights: str = "uniform",
) -> torch.Tensor:
    """Filtered back-projection, (..., A, P) -> (..., x_size, y_size), at
    (A,) angles in radians or per-example (..., A) ones.

    ``angle_weights``: 'uniform', the classical pi/(2A) (reference
    fbp_tensorflow.py:74), or 'voronoi' (``voronoi_angle_weights``, halved),
    which equals it on a uniform angle grid (fbp.py:134-168).
    """
    a = sinogram.shape[-2]
    filtered = filter_sinogram(sinogram, filter_name)
    if angle_weights == "voronoi":
        w = voronoi_angle_weights(torch.as_tensor(theta, dtype=torch.float32, device=sinogram.device))
        return _backproject_any(filtered * w[..., :, None], theta, x_size, y_size) * 0.5
    if angle_weights != "uniform":
        raise ValueError(f"unknown angle_weights {angle_weights!r}")
    recon = _backproject_any(filtered, theta, x_size, y_size)
    return recon * (math.pi / (2.0 * a))
