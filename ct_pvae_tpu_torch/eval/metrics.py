"""Image-quality metrics (port of ``ct_pvae_tpu/eval/metrics.py``, numpy).

``mse`` and ``psnr`` as metrics.py:22-33, with ``compare``'s convention
(metrics.py:72) that the data range is the reference image's max - min.
"""

from __future__ import annotations

import numpy as np


def mse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, data_range: float) -> float:
    err = mse(a, b)
    if err == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range**2) / err))


def mean_psnr(truth: np.ndarray, recon: np.ndarray) -> float:
    """PSNR per example (range of that example's ground truth), averaged."""
    vals = [psnr(t, r, float(t.max() - t.min())) for t, r in zip(truth, recon)]
    return float(np.mean(vals))
