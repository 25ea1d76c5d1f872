"""Filtered back-projection (port of ``ct_pvae_tpu/ops/fbp.py``).

rFFT filter multiply on the detector axis, then the pixel-driven
backprojector of ``radon.py``, with the classical uniform pi/(2A) angle
weight (``fbp.py:53-168``).  This is what the serving init stack runs: the
'gridrec' (ramp) and 'fbp' (shepp-logan) channels and the unfiltered mask
channel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .radon import backproject

FILTERS = ("ramp", "ramlak", "shepp", "shepp-logan", "cosine", "hamming", "hann", "none")

# The JAX package sends detectors of 512 pixels and more to its Pallas
# adjoint kernel (fbp.py:36-47, kernel D); the port has no such kernel yet.
_STRETCH_DETECTOR = 512


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


def fbp(
    sinogram: torch.Tensor,
    theta: torch.Tensor,
    x_size: int,
    y_size: int,
    filter_name: str = "ramp",
) -> torch.Tensor:
    """Filtered back-projection, (..., A, P) -> (..., x_size, y_size), with
    uniform angle weights (reference fbp_tensorflow.py:74)."""
    a, p = sinogram.shape[-2], sinogram.shape[-1]
    if p >= _STRETCH_DETECTOR and x_size == y_size:
        raise NotImplementedError(
            f"FBP at a {p}-pixel detector takes the JAX package's Pallas adjoint "
            "route (kernel D, ops/pallas_radon.py _adj_kernel), not yet ported "
            "(ROADMAP Queue 2)"
        )
    filtered = filter_sinogram(sinogram, filter_name)
    recon = backproject(filtered, theta, x_size, y_size)
    return recon * (math.pi / (2.0 * a))
