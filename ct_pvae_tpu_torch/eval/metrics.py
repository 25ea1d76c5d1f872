"""Image-quality metrics (a numpy/scipy copy of ``ct_pvae_tpu/eval/metrics.py``).

``mse``, ``psnr``, ``ssim`` (Wang et al. 2004 with skimage's defaults: a
uniform 7x7 window shrunk to the largest odd size for tiny images, K1 0.01,
K2 0.03, sample covariance, the mean over the border-cropped region) and
``compare``, whose data range is the first image's max - min
(metrics.py:22-83, the reference's helper_functions.py:394-418).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.ndimage import uniform_filter


def mse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, data_range: float) -> float:
    err = mse(a, b)
    if err == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range**2) / err))


def _auto_win_size(shape) -> int:
    small = min(shape)
    if small < 7:
        return small if small % 2 else small - 1
    return 7


def ssim(a: np.ndarray, b: np.ndarray, data_range: float, win_size: int = None) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if win_size is None:
        win_size = _auto_win_size(a.shape)
    if win_size < 1:
        raise ValueError("win_size must be >= 1")
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    np_win = win_size ** a.ndim
    cov_norm = np_win / (np_win - 1) if np_win > 1 else 1.0

    def filt(x):
        return uniform_filter(x, size=win_size)

    ux, uy = filt(a), filt(b)
    vx = cov_norm * (filt(a * a) - ux * ux)
    vy = cov_norm * (filt(b * b) - uy * uy)
    vxy = cov_norm * (filt(a * b) - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    if pad:
        s = s[tuple(slice(pad, dim - pad) for dim in s.shape)]
    return float(s.mean())


def compare(recon0: np.ndarray, recon1: np.ndarray, verbose: bool = False) -> Tuple[float, float, float]:
    """(MSE, SSIM, PSNR), the data range recon0.max() - recon0.min();
    ``verbose`` prints them as the reference does."""
    recon0 = np.asarray(recon0)
    recon1 = np.asarray(recon1)
    data_range = float(recon0.max() - recon0.min())
    m, s, p = mse(recon0, recon1), ssim(recon0, recon1, data_range), psnr(recon0, recon1, data_range)
    if verbose:
        print(f"MSE: {m:.8f}, SSIM: {s:.3f}, PSNR: {p:.3f}")
    return m, s, p


def mean_psnr(truth: np.ndarray, recon: np.ndarray) -> float:
    """PSNR per example (range of that example's ground truth), averaged."""
    vals = [psnr(t, r, float(t.max() - t.min())) for t, r in zip(truth, recon)]
    return float(np.mean(vals))
