"""Sequential Monte Carlo: adaptive likelihood tempering with HMC mutation
(port of ``ct_pvae_tpu/mcmc/smc.py``).

Particles are the leading axis. Each stage advances the inverse temperature
beta by bisection so that the effective sample size stays above
``ess_threshold * N`` (``next_beta``, smc.py:118-137),
resamples systematically (a sorted ``searchsorted``), mutates every
particle with a few HMC steps at the new temperature and adapts the shared
mutation step toward ``target_accept``. The targets are ``(N, D) -> (N,)``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

from .draws import DrawSource, as_draws, value_and_grad
from .hmc import leapfrog


class SMCConfig(NamedTuple):
    num_particles: int = 1024
    num_stages: int = 20          # max tempering stages
    ess_threshold: float = 0.5    # fraction of N
    mutation_steps: int = 5       # HMC steps per stage
    num_leapfrog: int = 5
    step_size: float = 0.1        # initial; adapted between stages
    target_accept: float = 0.5
    adapt_rate: float = 3.0


def _systematic_resample(u0: torch.Tensor, log_weights: torch.Tensor, n: int) -> torch.Tensor:
    """Ancestor indices of systematic resampling with offset ``u0`` in [0, 1)."""
    cum = torch.cumsum(torch.softmax(log_weights, 0), 0)
    pts = (u0 + torch.arange(n, dtype=torch.float32, device=log_weights.device)) / n
    return torch.clamp(torch.searchsorted(cum, pts), 0, n - 1)


def _ess(log_w: torch.Tensor) -> torch.Tensor:
    lw = log_w - torch.logsumexp(log_w, 0)
    return torch.exp(-torch.logsumexp(2.0 * lw, 0))


def next_beta(beta: torch.Tensor, loglik: torch.Tensor, ess_target: float) -> torch.Tensor:
    """The largest beta' in (beta, 1] with ESS((beta' - beta) * loglik) >=
    ``ess_target``: the JAX loop's bisection (at most 30 halvings, until the
    bracket is 1e-5 wide), run on the device as 30 masked halvings."""
    ess_at = lambda b: _ess((b - beta) * loglik)
    lo, hi = beta, torch.ones_like(beta)
    for _ in range(30):
        going = (hi - lo) > 1e-5
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= ess_target
        lo = torch.where(going & ok, mid, lo)
        hi = torch.where(going & ~ok, mid, hi)
    return torch.where(ess_at(torch.ones_like(beta)) >= ess_target, torch.ones_like(beta), lo)


def _mutate(log_prob, z, step, draws, cfg: SMCConfig):
    """``cfg.mutation_steps`` HMC steps of every particle at step size ``step``:
    (particles, each one's accept fraction)."""
    acc = torch.zeros(z.shape[0], dtype=torch.float32, device=z.device)
    for _ in range(cfg.mutation_steps):
        p0 = draws.normal("smc.momentum", z.shape, z.device)
        lp0, g0 = value_and_grad(log_prob, z)
        e0 = -lp0 + 0.5 * (p0 * p0).sum(-1)
        z1, p1, lp1, _ = leapfrog(log_prob, z, p0, g0, step, cfg.num_leapfrog)
        e1 = -lp1 + 0.5 * (p1 * p1).sum(-1)
        accept = draws.accept("smc.accept", torch.where(torch.isnan(e1), -math.inf, e0 - e1))
        z = torch.where(accept[:, None], z1, z)
        acc = acc + accept.float()
    return z, acc / cfg.mutation_steps


def smc_sample(
    log_prior_fn: Callable[[torch.Tensor], torch.Tensor],
    log_lik_fn: Callable[[torch.Tensor], torch.Tensor],
    init_particles: torch.Tensor,   # (N, D) draws from the prior (unconstrained space)
    draws: DrawSource,
    cfg: SMCConfig = SMCConfig(),
    beta0=None,                     # continuation inputs: resume a tempering run
    step_size0=None,                # from a finished call's diagnostics
    log_evidence0=None,
) -> Tuple[torch.Tensor, dict]:
    """Returns (particles (N, D), diagnostics), as smc.py:50-201."""
    draws = as_draws(draws)
    z = init_particles.detach().float()
    n = z.shape[0]
    f32 = dict(dtype=torch.float32, device=z.device)
    beta = torch.as_tensor(0.0 if beta0 is None else beta0, **f32)
    log_evidence = torch.as_tensor(0.0 if log_evidence0 is None else log_evidence0, **f32)
    step = torch.as_tensor(cfg.step_size if step_size0 is None else step_size0, **f32)
    stages_used = torch.zeros((), dtype=torch.int32, device=z.device)
    accept = torch.ones((), **f32)
    for _ in range(cfg.num_stages):
        # after beta reaches 1 the weights are uniform: the stages refine at the target
        done = beta >= 1.0
        with torch.no_grad():
            loglik = log_lik_fn(z)
        beta_new = next_beta(beta, loglik, cfg.ess_threshold * n)
        log_w = (beta_new - beta) * loglik
        log_evidence = log_evidence + (torch.logsumexp(log_w, 0) - math.log(n))
        idx = _systematic_resample(draws.uniform("smc.resample", (), z.device), log_w, n)
        tempered = lambda q, b=beta_new: log_prior_fn(q) + b * log_lik_fn(q)
        z, acc = _mutate(tempered, z[idx], step, draws, cfg)
        accept = acc.mean()
        step = torch.clamp(step * torch.exp(cfg.adapt_rate * (accept - cfg.target_accept)), 1e-5, 10.0)
        beta = beta_new
        stages_used = stages_used + (~done).to(torch.int32)
    return z, {
        "beta": beta,
        "log_evidence": log_evidence,
        "stages_used": stages_used,
        "last_accept": accept,
        "final_step_size": step,
    }
