"""Hamiltonian Monte Carlo over a batch of chains with step-size adaptation
(port of ``ct_pvae_tpu/mcmc/hmc.py``).

The target is a ``(C, D) -> (C,)`` log-prob of C chains at once (the JAX
sampler ``vmap``s a ``(D,) -> scalar`` one), so each leapfrog step is one
batched value-and-grad. Per-chain step sizes adapt toward a target accept
rate during the first ``num_adaptation`` iterations (the reference's
SimpleStepSizeAdaptation, hmc.py:102-114), averaged across chains with
``cross_chain_adapt``. The loop runs eagerly, one iteration at a time.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from .draws import DrawSource, as_draws, value_and_grad


class HMCConfig(NamedTuple):
    num_results: int = 1000
    num_burnin: int = 500
    num_leapfrog: int = 5                  # ref toy_mcmc_v2.py:47
    step_size: float = 6.5e-2              # ref toy_mcmc_v2.py:48
    num_adaptation: int = 400              # ref toy_mcmc_v2.py:134
    target_accept: float = 0.75
    adaptation_rate: float = 0.05
    cross_chain_adapt: bool = True


def leapfrog(log_prob_fn, x, p, g, step, num_steps):
    """``num_steps`` leapfrog steps from (x, p) with ``g`` the gradient at x:
    the closing half-kick's gradient opens the next step, so each step costs
    one value-and-grad. ``step`` is (C, 1). Returns (x, p, log_prob, grad)."""
    lp = None
    for _ in range(num_steps):
        p = p + 0.5 * step * g
        x = x + step * p
        lp, g = value_and_grad(log_prob_fn, x)
        p = p + 0.5 * step * g
    return x, p, lp, g


def hmc_sample(
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    init_state: torch.Tensor,          # (C, D) chains x dims, unconstrained space
    draws: DrawSource,
    cfg: HMCConfig = HMCConfig(),
    step_size0=None,                   # scalar or (C,) continuation step size
) -> Tuple[torch.Tensor, dict]:
    """Run HMC; returns (samples (num_results, C, D), diagnostics), as hmc.py:69-142."""
    if cfg.num_leapfrog < 1:
        raise ValueError("num_leapfrog must be >= 1")
    draws = as_draws(draws)
    x = init_state.detach().float()
    num_chains, dim = x.shape
    dev = x.device
    if step_size0 is None:
        step = torch.full((num_chains,), cfg.step_size, dtype=torch.float32, device=dev)
    else:
        step = torch.as_tensor(step_size0, dtype=torch.float32, device=dev).expand(num_chains).clone()
    samples, accepts = [], []
    for it in range(cfg.num_burnin + cfg.num_results):
        p0 = draws.normal("hmc.momentum", (num_chains, dim), dev)
        lp0, g0 = value_and_grad(log_prob_fn, x)
        ke0 = 0.5 * (p0 * p0).sum(-1)
        x_new, p_new, lp1, _ = leapfrog(log_prob_fn, x, p0, g0, step[:, None], cfg.num_leapfrog)
        ke1 = 0.5 * (p_new * p_new).sum(-1)
        log_accept = torch.where(torch.isfinite(lp1), (lp1 - ke1) - (lp0 - ke0), -torch.inf)
        accept = draws.accept("hmc.accept", log_accept)
        x = torch.where(accept[:, None], x_new, x)
        accept_prob = torch.clamp(torch.exp(log_accept), max=1.0)
        nudge = 0.0  # past adaptation the step still goes through exp(log(.)), as in JAX
        if it < cfg.num_adaptation:
            signal = accept_prob.mean() if cfg.cross_chain_adapt else accept_prob
            nudge = cfg.adaptation_rate * (signal - cfg.target_accept)
        step = torch.exp(torch.log(step) + nudge)
        if it >= cfg.num_burnin:
            samples.append(x)
            accepts.append(accept_prob)
    out = torch.stack(samples) if samples else x.new_zeros((0, num_chains, dim))
    acc = torch.stack(accepts) if accepts else x.new_zeros((0, num_chains))
    return out, {
        "accept_rate": acc.mean(),
        "final_step_size": step.mean(),
        "final_step_size_per_chain": step,
        "final_state": x,
    }
