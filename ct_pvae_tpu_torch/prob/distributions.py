"""Distributions of the ELBO and of the MCMC targets (port of
``ct_pvae_tpu/prob/distributions.py``).

``positive_range``, ``Normal``, ``TruncatedNormal``, ``Beta``, the
Normal-Normal and Beta-Beta KLs (distributions.py:32-179, 269-276) and
``betaln`` (the JAX package's, after scipy's ``betaln``/``algdiv``); then
the MCMC targets' ``Poisson``, ``Dirichlet``, ``DirichletMixture`` and
``toy_prior`` (distributions.py:182-259).
Sampling takes its draws as tensors (standard normal ``eps`` for Normal,
uniform ``u`` on [EPS, 1-EPS) for the truncated normal's inverse CDF, the
log-gamma variates of each concentration for Beta), so a test can feed the
port and the JAX package the same numbers.

``jax.random.beta`` draws log-gamma variates and differentiates them by
implicit reparameterisation: d log x / d a = (dF/da) / (dF/dx) / x at the
drawn x, F the gamma CDF.  ``reparam_log_gamma`` attaches that gradient to
given variates (torch's ``_standard_gamma_grad`` is the dF ratio), and
``draw_log_gamma`` draws them as ``jax.random.loggamma`` does: a shape
below 1 is boosted, log Ga(a) = log Ga(a + 1) + log(U) / a.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

EPS = float(torch.finfo(torch.float32).eps)
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_TINY = float(torch.finfo(torch.float32).tiny)


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


class _LogGammaReparam(torch.autograd.Function):
    """Identity on log-gamma variates ``log_x`` drawn with shape ``alpha``,
    whose gradient in ``alpha`` is the implicit one (``_gamma_grad`` of
    ``jax.random.loggamma``): random_gamma_grad(alpha, x) / x, x = exp(log_x)
    raised to the smallest normal float where it underflows."""

    @staticmethod
    def forward(ctx, alpha, log_x):
        ctx.save_for_backward(alpha, log_x)
        return log_x.clone()

    @staticmethod
    def backward(ctx, grad):
        alpha, log_x = ctx.saved_tensors
        x = torch.exp(log_x).clamp_min(_TINY)
        return grad * torch._standard_gamma_grad(alpha, x) / x, None


def reparam_log_gamma(alpha: torch.Tensor, log_x: torch.Tensor) -> torch.Tensor:
    """``log_x`` (log-gamma variates of shape ``alpha``, no gradient) carrying
    the implicit reparameterisation gradient in ``alpha``."""
    return _LogGammaReparam.apply(alpha, log_x.detach())


def draw_log_gamma(alpha: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """log Ga(alpha, 1) variates from ``gen`` on ``alpha``'s device, no
    gradient: shapes below 1 are boosted by one and scaled by U^(1/alpha), in
    log space, as ``jax.random.loggamma`` does."""
    alpha = alpha.detach()
    boost = alpha < 1.0
    g = torch._standard_gamma(torch.where(boost, alpha + 1.0, alpha), generator=gen)
    log_u = torch.log1p(-torch.rand(alpha.shape, generator=gen, device=alpha.device))
    return torch.log(g) + torch.where(boost, log_u / alpha, 0.0)


def _algdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ln(gamma(b) / gamma(a + b)) for b >= 8 and a <= b (the JAX package's
    ``algdiv``, after scipy's cdflib)."""
    c0, c1, c2 = 0.833333333333333e-01, -0.277777777760991e-02, 0.793650666825390e-03
    c3, c4, c5 = -0.595202931351870e-03, 0.837308034031215e-03, -0.165322962780713e-02
    h = a / b
    c = h / (1 + h)
    x = h / (1 + h)
    d = b + (a - 0.5)
    x2 = x * x
    s3 = 1.0 + (x + x2)
    s5 = 1.0 + (x + x2 * s3)
    s7 = 1.0 + (x + x2 * s5)
    s9 = 1.0 + (x + x2 * s7)
    s11 = 1.0 + (x + x2 * s9)
    t = (1.0 / b) ** 2
    w = ((((c5 * s11 * t + c4 * s9) * t + c3 * s7) * t + c2 * s5) * t + c1 * s3) * t + c0
    w = w * (c / b)
    u = d * torch.log1p(a / b)
    v = a * (torch.log(b) - 1.0)
    return torch.where(u <= v, (w - v) - u, (w - u) - v)


def betaln(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log B(a, b) as ``jax.scipy.special.betaln``: lgamma sums below 8,
    ``_algdiv`` above."""
    a, b = torch.minimum(a, b), torch.maximum(a, b)
    small_b = torch.lgamma(a) + (torch.lgamma(b) - torch.lgamma(a + b))
    large_b = torch.lgamma(a) + _algdiv(a, b)
    return torch.where(b < 8, small_b, large_b)


@dataclass
class Beta:
    a: torch.Tensor  # concentration1 (alpha)
    b: torch.Tensor  # concentration0 (beta)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return torch.xlogy(self.a - 1.0, x) + torch.xlogy(self.b - 1.0, 1.0 - x) - betaln(self.a, self.b)

    def sample(self, log_gamma_a: torch.Tensor, log_gamma_b: torch.Tensor) -> torch.Tensor:
        """The draw of ``jax.random.beta`` from the log-gamma variates of ``a``
        and ``b`` (no gradient; the implicit one is attached here):
        G_a / (G_a + G_b) computed from the logs without overflow."""
        la = reparam_log_gamma(self.a, log_gamma_a)
        lb = reparam_log_gamma(self.b, log_gamma_b)
        log_max = torch.maximum(la, lb)
        ga, gb = torch.exp(la - log_max), torch.exp(lb - log_max)
        return ga / (ga + gb)

    def mean(self) -> torch.Tensor:
        return self.a / (self.a + self.b)


def kl_beta_beta(p: Beta, q: Beta) -> torch.Tensor:
    """KL(Beta(a0, b0) || Beta(a1, b1)), elementwise (distributions.py:165-175)."""
    total_p = p.a + p.b
    return (betaln(q.a, q.b) - betaln(p.a, p.b) + (p.a - q.a) * torch.digamma(p.a)
            + (p.b - q.b) * torch.digamma(p.b) + (q.a - p.a + q.b - p.b) * torch.digamma(total_p))


@dataclass
class Poisson:
    rate: torch.Tensor

    def log_prob(self, k: torch.Tensor) -> torch.Tensor:
        """The continuous relaxation (defined for real ``k``), rate floored at EPS."""
        safe_rate = torch.clamp(self.rate, min=EPS)
        return torch.xlogy(k, safe_rate) - safe_rate - torch.lgamma(k + 1.0)

    def mean(self) -> torch.Tensor:
        return self.rate


def _sample_dirichlet(concentration: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Dirichlet draws of ``concentration``'s shape: log-gamma variates
    normalised in log space, since a float32 gamma draw of a concentration
    like ``toy_prior``'s 0.0039 underflows to 0."""
    return torch.softmax(draw_log_gamma(concentration, gen), dim=-1)


@dataclass
class Dirichlet:
    concentration: torch.Tensor  # (..., K)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        c = self.concentration
        norm = torch.lgamma(c).sum(-1) - torch.lgamma(c.sum(-1))
        return torch.xlogy(c - 1.0, x).sum(-1) - norm

    def sample(self, gen: torch.Generator, sample_shape: tuple = ()) -> torch.Tensor:
        return _sample_dirichlet(self.concentration.expand(tuple(sample_shape) + self.concentration.shape), gen)

    def mean(self) -> torch.Tensor:
        c = self.concentration
        return c / c.sum(-1, keepdim=True)


@dataclass
class DirichletMixture:
    """Finite mixture of Dirichlets (the toy prior, helper_functions.py:531-559)."""

    log_weights: torch.Tensor     # (M,)
    concentrations: torch.Tensor  # (M, K)

    @classmethod
    def create(cls, weights, concentrations) -> "DirichletMixture":
        return cls(log_weights=torch.log(torch.as_tensor(weights, dtype=torch.float32)),
                   concentrations=torch.as_tensor(concentrations, dtype=torch.float32))

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        comp = Dirichlet(self.concentrations).log_prob(x[..., None, :])  # (..., M)
        return torch.logsumexp(self.log_weights + comp, dim=-1)

    def sample(self, gen: torch.Generator, sample_shape: tuple = ()) -> torch.Tensor:
        """A component drawn by weight, then a draw of that component."""
        shape = tuple(sample_shape)
        idx = torch.multinomial(torch.softmax(self.log_weights, 0), max(1, math.prod(shape)),
                                replacement=True, generator=gen).reshape(shape)
        draws = _sample_dirichlet(self.concentrations.expand(shape + self.concentrations.shape), gen)
        pick = idx[..., None, None].expand(shape + (1, self.concentrations.shape[-1]))
        return torch.gather(draws, -2, pick)[..., 0, :]

    def to(self, device) -> "DirichletMixture":
        return DirichletMixture(self.log_weights.to(device), self.concentrations.to(device))


def toy_prior(
    mix_prob: float = 0.3,
    conc_0=(0.35580334, 0.94963009, 0.60227688, 0.43061459),
    conc_1=(0.00390356, 0.44335424, 0.83152378, 0.52733124),
) -> DirichletMixture:
    """The toy 2x2 simplex prior P(O) (reference helper_functions.py:531-559)."""
    return DirichletMixture.create([mix_prob, 1.0 - mix_prob], [conc_0, conc_1])
