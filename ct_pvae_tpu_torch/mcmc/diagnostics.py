"""Convergence diagnostics: effective sample size and split R-hat (a copy of
``ct_pvae_tpu/mcmc/diagnostics.py``, which is pure numpy).

Geyer initial-monotone-sequence ESS and Gelman-Rubin split R-hat over the
(T, C, D) sample layout every sampler returns, on the host: diagnostics run
once per study, not per step.
"""

from __future__ import annotations

import numpy as np


def effective_sample_size(samples: np.ndarray) -> np.ndarray:
    """Geyer initial-monotone ESS per dimension.

    ``samples``: (T, C, D) or (T, D).  Autocovariance is estimated per chain
    via FFT and averaged; successive pair sums are truncated at the first
    negative and enforced monotone.  Returns (D,) ESS estimates.
    """
    x = np.asarray(samples, np.float64)
    if x.ndim == 2:
        x = x[:, None, :]
    t, c, d = x.shape
    if t < 4:
        return np.full((d,), float(t * c))

    # per-chain autocovariance via FFT, averaged over chains
    xc = x - x.mean(axis=0, keepdims=True)
    n_fft = 1 << (2 * t - 1).bit_length()
    f = np.fft.rfft(xc, n=n_fft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=n_fft, axis=0)[:t].real
    acov /= t  # biased normalization (standard for ESS)
    acov = acov.mean(axis=1)  # (T, D) averaged over chains

    var = acov[0]
    var = np.where(var <= 0, 1e-300, var)
    rho = acov / var  # (T, D)

    # Geyer: sum of adjacent-pair autocorrelations while positive, enforced
    # non-increasing — vectorized over dimensions (image-scale studies score
    # every pixel, so d can be 16384+)
    n_pair = t // 2
    pair = rho[0 : 2 * n_pair : 2] + rho[1 : 2 * n_pair : 2]   # (n_pair, D)
    neg = pair < 0
    first_neg = np.where(neg.any(axis=0), neg.argmax(axis=0), n_pair)  # (D,)
    valid = np.arange(n_pair)[:, None] < first_neg[None, :]
    # running-min enforcement == the sequential min(p, prev) clip
    monotone = np.minimum.accumulate(pair, axis=0)
    s = np.where(valid, monotone, 0.0).sum(axis=0)
    tau = np.maximum(2.0 * s - 1.0, 1.0)
    return t * c / tau


def split_rhat(samples: np.ndarray) -> np.ndarray:
    """Split Gelman-Rubin R-hat per dimension; samples (T, C, D)."""
    x = np.asarray(samples, np.float64)
    if x.ndim == 2:
        x = x[:, None, :]
    t, c, d = x.shape
    half = t // 2
    # split each chain in two
    x = np.concatenate([x[:half], x[half : 2 * half]], axis=1)  # (half, 2C, D)
    t, m, _ = x.shape
    chain_means = x.mean(axis=0)           # (M, D)
    chain_vars = x.var(axis=0, ddof=1)     # (M, D)
    w = chain_vars.mean(axis=0)
    b = t * chain_means.var(axis=0, ddof=1)
    var_plus = (t - 1) / t * w + b / t
    return np.sqrt(var_plus / np.where(w <= 0, 1e-300, w))
