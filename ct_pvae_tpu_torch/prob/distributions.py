"""Distributions of the ELBO (port of ``ct_pvae_tpu/prob/distributions.py``).

``positive_range``, ``Normal``, ``TruncatedNormal`` and the Normal-Normal KL
(distributions.py:32-135).  Sampling takes its draws as tensors (standard
normal ``eps`` for Normal, uniform ``u`` on [EPS, 1-EPS) for the truncated
normal's inverse CDF), so a test can feed the port and the JAX package the
same numbers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

EPS = float(torch.finfo(torch.float32).eps)
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def positive_range(x: torch.Tensor, offset: float = EPS) -> torch.Tensor:
    """``exp(x-1)+offset`` below 1, identity above (helper_functions.py:198-201)."""
    xm1 = x - 1.0
    expo = torch.exp(torch.clamp(xm1, -1e10, 10.0)) + offset
    return torch.where(xm1 < 0, expo, x)


@dataclass
class Normal:
    loc: torch.Tensor
    scale: torch.Tensor

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - torch.log(self.scale) - _HALF_LOG_2PI

    def sample(self, eps: torch.Tensor) -> torch.Tensor:
        """Reparameterised draw from a standard-normal ``eps`` of the batch shape."""
        return self.loc + self.scale * eps

    def mean(self) -> torch.Tensor:
        return self.loc


def kl_normal_normal(p: Normal, q: Normal) -> torch.Tensor:
    """KL(N(m0, s0) || N(m1, s1)), elementwise."""
    var_ratio = torch.square(p.scale / q.scale)
    t1 = torch.square((p.loc - q.loc) / q.scale)
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


@dataclass
class TruncatedNormal:
    """Normal(loc, scale) truncated to [low, high] (the per-pixel output
    distribution, helper_functions.py:273)."""

    loc: torch.Tensor
    scale: torch.Tensor
    low: float
    high: float

    def _alpha_beta(self):
        a = (self.low - self.loc) / self.scale
        b = (self.high - self.loc) / self.scale
        return a, b

    def _log_z(self) -> torch.Tensor:
        a, b = self._alpha_beta()
        z = torch.special.ndtr(b) - torch.special.ndtr(a)
        return torch.log(torch.clamp(z, min=EPS))

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        lp = -0.5 * z * z - torch.log(self.scale) - _HALF_LOG_2PI - self._log_z()
        inside = (x >= self.low) & (x <= self.high)
        return torch.where(inside, lp, -math.inf)

    def sample(self, u: torch.Tensor) -> torch.Tensor:
        """Inverse-CDF draw from a uniform ``u`` on [EPS, 1-EPS)."""
        a, b = self._alpha_beta()
        fa = torch.special.ndtr(a)
        fb = torch.special.ndtr(b)
        q = torch.clamp(fa + u * (fb - fa), EPS, 1.0 - EPS)
        x = self.loc + self.scale * torch.special.ndtri(q)
        return torch.clamp(x, self.low, self.high)

    def mean(self) -> torch.Tensor:
        a, b = self._alpha_beta()
        phi_a = torch.exp(-0.5 * a * a) * _INV_SQRT_2PI
        phi_b = torch.exp(-0.5 * b * b) * _INV_SQRT_2PI
        z = torch.clamp(torch.special.ndtr(b) - torch.special.ndtr(a), min=EPS)
        return self.loc + self.scale * (phi_a - phi_b) / z
