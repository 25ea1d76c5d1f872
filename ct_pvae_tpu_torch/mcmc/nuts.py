"""No-U-Turn Sampler over a batch of chains (port of ``ct_pvae_tpu/mcmc/nuts.py``).

Multinomial NUTS in the iterative form of nuts.py:1-27: a subtree of depth
j is built leaf by leaf (2^j leapfrog steps), its U-turn checks use binary
checkpoints (an even leaf ``l`` is stored at slot popcount(l); at an odd
leaf ``n`` with t trailing one-bits the intervals ending at n start at the
slots popcount(n)-1 ... popcount(n)-t), the proposal is streamed by
progressive multinomial sampling, an energy error above ``max_energy_error``
ends the trajectory, and the outer loop doubles the trajectory in a random
direction. Warm-up adapts the step size (dual averaging) and a diagonal
mass matrix (Welford over a window of the burn-in, pooled over chains).

The JAX sampler ``vmap``s a ``while_loop`` over chains: the body runs for
every chain while any is active and the carry of a finished chain is frozen.
Here the chains are the leading axis of every state tensor and run in
lockstep under masks: a chain whose subtree or trajectory has ended changes
no state and consumes no draw, and the active chains share one depth and
one leaf index, so one (C, max_depth + 1, D) checkpoint buffer serves all of
them. The loop condition is read on the host once per leaf; each leaf costs
one batched value-and-grad of the ``(C, D) -> (C,)`` target.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

from .draws import LOG_HALF, DrawSource, as_draws, value_and_grad


class NUTSConfig(NamedTuple):
    num_results: int = 1000
    num_burnin: int = 500
    step_size: float = 0.1
    max_depth: int = 8
    max_energy_error: float = 1000.0
    # dual-averaging step-size adaptation (Hoffman & Gelman 2014)
    target_accept: float = 0.8
    adapt_step_size: bool = True
    t0: float = 10.0
    gamma: float = 0.05
    kappa: float = 0.75
    # diagonal mass matrix: Welford over iterations [w0, w1) * num_burnin,
    # installed at w1 * num_burnin with a dual-averaging restart (nuts.py:56-67);
    # chunked callers pass welford0 with window (0, 1) and install_mass=False
    adapt_mass: bool = True
    mass_reg: float = 1e-3
    welford_window: Tuple[float, float] = (0.1, 0.9)
    install_mass: bool = True


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _count_trailing_ones(n: int) -> int:
    return _popcount(n & ~(n + 1))


def _uturn(z_left, v_left, z_right, v_right) -> torch.Tensor:
    """(C,) U-turn test on velocities v = M^{-1} r."""
    dz = z_right - z_left
    return ((dz * v_left).sum(-1) < 0) | ((dz * v_right).sum(-1) < 0)


def _leapfrog(vg, z, r, g, eps, inv_mass):
    """One leapfrog step with the gradient ``g`` at z cached from the step
    before: one value-and-grad a leaf. ``eps`` is (C, 1)."""
    r = r + 0.5 * eps * g
    z = z + eps * inv_mass * r
    lp, g = vg(z)
    r = r + 0.5 * eps * g
    return z, r, lp, g


def _keep(mask, new, old):
    """``new`` where the (C,) ``mask`` holds, else ``old``, for (C,) or (C, D) tensors."""
    return torch.where(mask.view((-1,) + (1,) * (new.dim() - 1)), new, old)


class _Tree(NamedTuple):
    z_proposal: torch.Tensor
    log_weight: torch.Tensor   # logsumexp of the leaf weights
    edge: tuple                # (z, r, g, lp): the outermost state in the growth direction
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor   # sum of min(1, exp(energy0 - energy)) for dual averaging
    num_leaves: torch.Tensor


def _build_subtree(vg, edge, depth: int, direction, eps, inv_mass, energy0, active, count: int,
                   draws, max_depth: int, max_energy_error: float) -> _Tree:
    """The subtrees of 2^depth leaves from each active chain's ``edge``
    (nuts.py:112-229); ``direction`` is (C,) +-1."""
    z, r, g, lp = edge
    num_chains, dim = z.shape
    d = direction[:, None]
    eps_d = eps * d
    z_ckpts = z.new_zeros((num_chains, max_depth + 1, dim))
    r_ckpts = z.new_zeros((num_chains, max_depth + 1, dim))
    z_prop = z
    log_w = torch.full_like(lp, -math.inf)
    turning = torch.zeros_like(active)
    diverging = torch.zeros_like(active)
    sum_accept = torch.zeros_like(lp)
    leaves = torch.zeros_like(lp, dtype=torch.int32)
    act = active
    leaf = 0
    while leaf < (1 << depth) and count > 0:
        z_n, r_n, lp_n, g_n = _leapfrog(vg, z, r, g, eps_d, inv_mass)
        delta = (-lp_n + 0.5 * (r_n * r_n * inv_mass).sum(-1)) - energy0
        div = delta > max_energy_error  # NaN-blind, as the reference (ADVICE.md)
        log_w_leaf = torch.where(torch.isnan(delta), -math.inf, -delta)
        accept_p = torch.clamp(torch.exp(-delta), max=1.0)
        accept_p = torch.where(torch.isnan(accept_p), 0.0, accept_p)

        # progressive multinomial sampling
        log_w_new = torch.logaddexp(log_w, log_w_leaf)
        take = draws.accept("nuts.leaf", log_w_leaf - log_w_new, act, count)
        z_prop = _keep(take, z_n, z_prop)

        # U-turn bookkeeping via binary checkpoints; the slots are the same for every chain
        turn = turning
        if leaf % 2 == 0:
            slot = _popcount(leaf)
            z_ckpts[:, slot] = _keep(act, z_n, z_ckpts[:, slot])
            r_ckpts[:, slot] = _keep(act, r_n, r_ckpts[:, slot])
        else:
            hi = _popcount(leaf) - 1
            v_right = inv_mass * r_n * d
            for j in range(_count_trailing_ones(leaf)):
                v_left = inv_mass * r_ckpts[:, hi - j] * d
                turn = turn | _uturn(z_ckpts[:, hi - j], v_left, z_n, v_right)

        z, r, g, lp = (_keep(act, new, old) for new, old in ((z_n, z), (r_n, r), (g_n, g), (lp_n, lp)))
        log_w = _keep(act, log_w_new, log_w)
        turning = _keep(act, turn, turning)
        diverging = diverging | (act & div)
        sum_accept = _keep(act, sum_accept + accept_p, sum_accept)
        leaves = leaves + act.to(torch.int32)
        leaf += 1
        act = act & ~turning & ~diverging
        count = int(act.sum())  # the loop condition, read once per leaf
    return _Tree(z_prop, log_w, (z, r, g, lp), turning, diverging, sum_accept, leaves)


def _nuts_one_step(vg, z, eps, inv_mass, draws, cfg: NUTSConfig):
    """One NUTS transition of every chain (nuts.py:232-341): (proposals, accept statistics)."""
    num_chains, dim = z.shape
    r0 = draws.normal("nuts.momentum", (num_chains, dim), z.device) * torch.rsqrt(inv_mass)
    lp0, g0 = vg(z)  # the transition's only evaluation that is not a leaf
    energy0 = -lp0 + 0.5 * (r0 * r0 * inv_mass).sum(-1)
    left = right = (z, r0, g0, lp0)
    z_prop = z
    log_w = torch.zeros_like(lp0)   # the initial state's weight, relative to energy0
    turning = torch.zeros_like(lp0, dtype=torch.bool)
    diverging = torch.zeros_like(turning)
    sum_accept = torch.zeros_like(lp0)
    num_leaves = torch.ones_like(lp0, dtype=torch.int32)
    active, count = ~turning, num_chains
    log_half = torch.full_like(lp0, LOG_HALF)
    depth = 0
    while depth < cfg.max_depth and count > 0:
        forward = draws.accept("nuts.direction", log_half, active, count)
        direction = torch.where(forward, 1.0, -1.0)
        edge = tuple(_keep(forward, rt, lt) for rt, lt in zip(right, left))
        tree = _build_subtree(vg, edge, depth, direction, eps, inv_mass, energy0, active, count, draws,
                              cfg.max_depth, cfg.max_energy_error)
        # merge edges (their gradients and log-probs ride along)
        left = tuple(_keep(active & ~forward, te, lt) for te, lt in zip(tree.edge, left))
        right = tuple(_keep(active & forward, te, rt) for te, rt in zip(tree.edge, right))

        ok = ~tree.turning & ~tree.diverging
        # biased progressive sampling between the old tree and the new subtree
        accept_new = draws.accept("nuts.merge", tree.log_weight - log_w, active, count)
        z_prop = _keep(ok & accept_new, tree.z_proposal, z_prop)
        log_w = _keep(active, torch.logaddexp(log_w, torch.where(ok, tree.log_weight, -math.inf)), log_w)
        turning_across = _uturn(left[0], inv_mass * left[1], right[0], inv_mass * right[1])
        turning = _keep(active, tree.turning | turning_across, turning)
        diverging = diverging | (active & tree.diverging)
        sum_accept = _keep(active, sum_accept + tree.sum_accept, sum_accept)
        num_leaves = num_leaves + tree.num_leaves
        depth += 1
        active = active & ~turning & ~diverging
        count = int(active.sum())
    accept_stat = sum_accept / torch.clamp(num_leaves.float() - 1.0, min=1.0)
    return z_prop, accept_stat


def nuts_sample(
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    init_state: torch.Tensor,   # (C, D)
    draws: DrawSource,
    cfg: NUTSConfig = NUTSConfig(),
    inv_mass0=None,             # (D,) continuation metric (default: identity)
    step_size0=None,            # scalar continuation step size (default: cfg)
    welford0=None,              # (count, mean (D,), m2 (D,))
    da0=None,                   # (log_eps_avg, h_avg, da_m, mu): dual-averaging continuation
) -> Tuple[torch.Tensor, dict]:
    """Run NUTS with dual-averaging and mass-matrix warm-up; returns
    (samples (num_results, C, D), diagnostics), as nuts.py:344-512.

    ``inv_mass0``, ``step_size0``, ``welford0`` and ``da0`` continue a
    finished call from its ``diag["inv_mass"]``, ``diag["final_step_size"]``,
    ``diag["welford"]`` and ``diag["da"]`` (with ``diag["final_state"]`` as
    ``init_state``), so a chunked caller's calls make one run."""
    draws = as_draws(draws)
    z = init_state.detach().float()
    num_chains, dim = z.shape
    dev = z.device
    f32 = dict(dtype=torch.float32, device=dev)
    vg = lambda q: value_and_grad(log_prob_fn, q)
    do_mass = bool(cfg.adapt_mass) and (welford0 is not None or cfg.num_burnin >= 50)
    w0 = int(cfg.welford_window[0] * cfg.num_burnin)
    w1 = int(cfg.welford_window[1] * cfg.num_burnin)

    log_eps = torch.log(torch.as_tensor(cfg.step_size if step_size0 is None else step_size0, **f32))
    inv_mass = torch.ones(dim, **f32) if inv_mass0 is None else torch.as_tensor(inv_mass0, **f32)
    if welford0 is None:
        w_count, w_mean, w_m2 = torch.zeros((), **f32), torch.zeros(dim, **f32), torch.zeros(dim, **f32)
    else:
        w_count, w_mean, w_m2 = (torch.as_tensor(v, **f32) for v in welford0)
    if da0 is None:
        log_eps_avg, h_avg = log_eps, torch.zeros((), **f32)
        da_m, mu = torch.zeros((), dtype=torch.int32, device=dev), math.log(10.0) + log_eps
    else:
        log_eps_avg, h_avg, mu = (torch.as_tensor(da0[i], **f32) for i in (0, 1, 3))
        da_m = torch.as_tensor(da0[2], dtype=torch.int32, device=dev)

    samples, accepts = [], []
    for it in range(cfg.num_burnin + cfg.num_results):
        z, accept = _nuts_one_step(vg, z, torch.exp(log_eps), inv_mass, draws, cfg)
        mean_accept = accept.mean()

        # dual averaging during burn-in (restartable counter da_m)
        if it < cfg.num_burnin and cfg.adapt_step_size:
            m = da_m.float() + 1.0
            h_avg = (1.0 - 1.0 / (m + cfg.t0)) * h_avg + (cfg.target_accept - mean_accept) / (m + cfg.t0)
            log_eps = mu - torch.sqrt(m) / cfg.gamma * h_avg
            w = m ** (-cfg.kappa)
            log_eps_avg = w * log_eps + (1.0 - w) * log_eps_avg
            da_m = da_m + 1
        else:
            log_eps = log_eps_avg

        if do_mass:
            if w0 <= it < w1:  # Welford over this iteration's C chain positions
                bmean = z.mean(0)
                bm2 = torch.square(z - bmean).sum(0)
                delta = bmean - w_mean
                tot = w_count + num_chains
                w_mean = w_mean + delta * (num_chains / tot)
                w_m2 = w_m2 + bm2 + torch.square(delta) * (w_count * num_chains / tot)
                w_count = tot
            if cfg.install_mass and it == w1:
                # install the regularised variance and restart dual averaging
                n = torch.clamp(w_count, min=2.0)
                var = w_m2 / (n - 1.0)
                var_reg = (n / (n + 5.0)) * var + (5.0 / (n + 5.0)) * cfg.mass_reg
                inv_mass = torch.clamp(var_reg, min=1e-10)
                da_m = torch.zeros_like(da_m)
                h_avg = torch.zeros_like(h_avg)
                mu = log_eps + math.log(10.0)
                log_eps_avg = log_eps
        if it >= cfg.num_burnin:
            samples.append(z)
            accepts.append(mean_accept)
    out = torch.stack(samples) if samples else z.new_zeros((0, num_chains, dim))
    return out, {
        "accept_rate": torch.stack(accepts).mean() if accepts else torch.full((), math.nan, **f32),
        "final_step_size": torch.exp(log_eps),
        "inv_mass": inv_mass,
        "final_state": z,
        "welford": (w_count, w_mean, w_m2),
        "da": (log_eps_avg, h_avg, da_m, mu),
    }
