"""The port's samplers and toy posterior (``ct_pvae_tpu_torch/mcmc``,
``prob/bijectors.py``, ``prob/distributions.py``, ``eval/mcmc_run.py``
``run_toy_mcmc``) against the JAX package on the CPU.

Deterministic pieces take the same numpy inputs on both sides.  Transitions
take the JAX sampler's own draws: ``JaxSamplerKeys`` walks its key tree, so
one port transition is held against one JAX transition, position by
position, and every decision on the way (take, merge, direction, accept and
U-turn) is checked to lie at least ``MARGIN`` from its threshold, so that
agreement is neither luck nor lost to rounding.  Whole samplers are held to
the moments of closed-form targets.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxSamplerKeys
from ct_pvae_tpu.mcmc import diagnostics as jax_diag
from ct_pvae_tpu.mcmc import hmc as jax_hmc
from ct_pvae_tpu.mcmc import nuts as jax_nuts
from ct_pvae_tpu.mcmc import smc as jax_smc
from ct_pvae_tpu.mcmc.toy_model import toy_joint_log_prob as jax_toy_joint
from ct_pvae_tpu.mcmc.toy_model import toy_posterior_sampler as jax_toy_sampler
from ct_pvae_tpu.prob import distributions as jax_dist
from ct_pvae_tpu.prob.bijectors import IteratedSigmoidCentered as JaxISC
from ct_pvae_tpu_torch import cli
from ct_pvae_tpu_torch.mcmc import diagnostics, hmc, nuts, smc
from ct_pvae_tpu_torch.mcmc.toy_model import toy_joint_log_prob, toy_posterior_sampler
from ct_pvae_tpu_torch.prob import distributions as dist
from ct_pvae_tpu_torch.prob.bijectors import IteratedSigmoidCentered

MARGIN = 1e-4       # least distance of a replayed decision from its threshold
POS_ATOL = 1e-5     # positions after replayed transitions (float32 rounding of O(1) states)

_MEAN = np.array([1.0, -0.5], np.float32)
_COV = np.array([[1.0, 0.6], [0.6, 0.8]], np.float32)


def _gauss_jax(z):  # tests/test_mcmc.py:29-35
    prec = jnp.linalg.inv(jnp.asarray(_COV))
    d = z - jnp.asarray(_MEAN)
    return -0.5 * d @ prec @ d


def _gauss_torch(z):
    prec = torch.linalg.inv(torch.from_numpy(_COV))
    d = z - torch.from_numpy(_MEAN)
    return -0.5 * ((d @ prec) * d).sum(-1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _n(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


@pytest.fixture
def uturn_margins(monkeypatch):
    """Records each U-turn dot product of the chains of the latest decision,
    relative to |dz| |v|, through the replay source ``keys`` set on the list."""
    class Seen(list):
        keys = None

    seen = Seen()
    real = nuts._uturn

    def recording(z_left, v_left, z_right, v_right):
        act = seen.keys.last_active
        dz = z_right - z_left
        for v in (v_left, v_right):
            rel = (dz * v).sum(-1).abs() / (dz.norm(dim=-1) * v.norm(dim=-1)).clamp_min(1e-30)
            seen.extend(rel.numpy()[act])
        return real(z_left, v_left, z_right, v_right)

    monkeypatch.setattr(nuts, "_uturn", recording)
    return seen


# -- deterministic pieces -------------------------------------------------------


def test_popcount_trailing_ones_and_uturn_match_jax():
    leaves = np.arange(300, dtype=np.int32)
    np.testing.assert_array_equal([nuts._popcount(int(n)) for n in leaves],
                                  np.asarray(jax_nuts._popcount(jnp.asarray(leaves))))
    np.testing.assert_array_equal([nuts._count_trailing_ones(int(n)) for n in leaves],
                                  np.asarray(jax_nuts._count_trailing_ones(jnp.asarray(leaves))))
    rng = np.random.default_rng(0)
    zl, vl, zr, vr = (rng.normal(size=(64, 5)).astype(np.float32) for _ in range(4))
    want = [bool(jax_nuts._uturn(*(jnp.asarray(a[i]) for a in (zl, vl, zr, vr)))) for i in range(64)]
    got = nuts._uturn(_t(zl), _t(vl), _t(zr), _t(vr)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < 64


def test_leapfrog_matches_jax():
    rng = np.random.default_rng(1)
    z, r = rng.normal(size=(4, 2)).astype(np.float32), rng.normal(size=(4, 2)).astype(np.float32)
    inv_mass = np.array([0.7, 1.3], np.float32)
    eps = np.array([0.1, -0.2, 0.05, 0.3], np.float32)
    vg = jax.value_and_grad(_gauss_jax)
    want = [jax_nuts._leapfrog(vg, jnp.asarray(z[i]), jnp.asarray(r[i]), vg(jnp.asarray(z[i]))[1],
                               eps[i], jnp.asarray(inv_mass)) for i in range(4)]
    g0 = torch.func.vmap(torch.func.grad(lambda q: _gauss_torch(q[None])[0]))(_t(z))
    got = nuts._leapfrog(lambda q: nuts.value_and_grad(_gauss_torch, q), _t(z), _t(r), g0,
                         _t(eps)[:, None], _t(inv_mass))
    for k in range(4):
        np.testing.assert_allclose(_n(got[k]), np.stack([np.asarray(w[k]) for w in want]),
                                   rtol=1e-6, atol=1e-6)


def test_iterated_sigmoid_centered_matches_jax():
    x = np.random.default_rng(2).normal(size=(10, 3)).astype(np.float32) * 2
    xj, xt = jnp.asarray(x), _t(x)
    y = _n(IteratedSigmoidCentered.forward(xt))
    np.testing.assert_allclose(y, np.asarray(JaxISC.forward(xj)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(y.sum(-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(_n(IteratedSigmoidCentered.forward_log_det_jacobian(xt)),
                               np.asarray(JaxISC.forward_log_det_jacobian(xj)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_n(IteratedSigmoidCentered.inverse(_t(y))),
                               np.asarray(JaxISC.inverse(jnp.asarray(y))), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_n(IteratedSigmoidCentered.inverse(_t(y))), x, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_n(IteratedSigmoidCentered.forward(torch.zeros(3))), 0.25, atol=1e-7)


def test_poisson_dirichlet_and_toy_prior_log_probs_match_jax():
    rng = np.random.default_rng(3)
    rate = rng.uniform(0, 50, (6, 5)).astype(np.float32)
    rate[0, 0] = 0.0  # floored at EPS
    k = rng.uniform(0, 60, (6, 5)).astype(np.float32)
    np.testing.assert_allclose(_n(dist.Poisson(_t(rate)).log_prob(_t(k))),
                               np.asarray(jax_dist.Poisson(jnp.asarray(rate)).log_prob(jnp.asarray(k))),
                               rtol=1e-5, atol=1e-4)
    conc = rng.uniform(0.2, 3.0, (3, 4)).astype(np.float32)
    x = rng.dirichlet(np.ones(4), 3).astype(np.float32)
    np.testing.assert_allclose(_n(dist.Dirichlet(_t(conc)).log_prob(_t(x))),
                               np.asarray(jax_dist.Dirichlet(jnp.asarray(conc)).log_prob(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    pts = rng.dirichlet(np.ones(4), 16).astype(np.float32)
    np.testing.assert_allclose(_n(dist.toy_prior().log_prob(_t(pts))),
                               np.asarray(jax_dist.toy_prior().log_prob(jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-5)


def test_dirichlet_mixture_draws_the_prior():
    """The log-space draws reach the 0.0039 concentration without underflow
    and match the mixture's mean."""
    prior = dist.toy_prior()
    x = prior.sample(torch.Generator().manual_seed(0), (20000,))
    assert x.shape == (20000, 4) and torch.isfinite(x).all()
    np.testing.assert_allclose(_n(x.sum(-1)), 1.0, atol=1e-5)
    c = prior.concentrations
    want = (torch.softmax(prior.log_weights, 0)[:, None] * c / c.sum(-1, keepdim=True)).sum(0)
    np.testing.assert_allclose(_n(x.mean(0)), _n(want), atol=0.01)


def _toy_inputs():
    theta = np.array([0.0, np.pi / 2], np.float32)
    mask = np.array([0.5, 0.5], np.float32)
    meas = np.array([[0.31, 0.22], [0.18, 0.33]], np.float32)
    return theta, mask, meas


def test_toy_joint_log_prob_and_sampler_match_jax():
    theta, mask, meas = _toy_inputs()
    pts = np.random.default_rng(4).dirichlet(np.ones(4), 5).astype(np.float32)
    want = [float(jax_toy_joint(jnp.asarray(p), jnp.asarray(meas), jnp.asarray(theta), jnp.asarray(mask), 1e3))
            for p in pts]
    got = toy_joint_log_prob(_t(pts), _t(meas), _t(theta), _t(mask), 1e3)
    np.testing.assert_allclose(_n(got), want, rtol=1e-5, atol=1e-3)
    x = np.random.default_rng(5).normal(size=(5, 3)).astype(np.float32)
    lp_j = jax_toy_sampler(jnp.asarray(meas), jnp.asarray(theta), jnp.asarray(mask), 1e3)
    lp_t = toy_posterior_sampler(_t(meas), _t(theta), _t(mask), 1e3)
    v, g = nuts.value_and_grad(lp_t, _t(x))
    for i in range(5):
        vj, gj = jax.value_and_grad(lp_j)(jnp.asarray(x[i]))
        np.testing.assert_allclose(float(v[i]), float(vj), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(_n(g[i]), np.asarray(gj), rtol=1e-4, atol=1e-3 * np.abs(gj).max())


def test_systematic_resample_ess_and_next_beta_match_jax():
    rng = np.random.default_rng(6)
    log_w = rng.normal(size=32).astype(np.float32) * 2
    key = jax.random.PRNGKey(3)
    u0 = float(jax.random.uniform(key, ()))
    idx = smc._systematic_resample(torch.tensor(u0), _t(log_w), 32)
    np.testing.assert_array_equal(_n(idx), np.asarray(jax_smc._systematic_resample(key, jnp.asarray(log_w), 32)))
    cum = np.cumsum(np.exp(log_w - log_w.max()) / np.exp(log_w - log_w.max()).sum())
    assert np.abs((u0 + np.arange(32))[:, None] / 32 - cum[None]).min() > MARGIN
    np.testing.assert_allclose(float(smc._ess(_t(log_w))), float(jax_smc._ess(jnp.asarray(log_w))), rtol=1e-5)
    loglik = rng.normal(size=64).astype(np.float32) * 30 - 100
    for beta in (0.0, 0.37):
        got = float(smc.next_beta(torch.tensor(beta), _t(loglik), 32.0))
        # the JAX loop's bisection, as smc.py:118-137 writes it
        ess_at = lambda b: jax_smc._ess((b - beta) * jnp.asarray(loglik))
        lo, hi = jnp.float32(beta), jnp.float32(1.0)
        for _ in range(30):
            if not hi - lo > 1e-5:
                break
            mid = 0.5 * (lo + hi)
            lo, hi = (mid, hi) if ess_at(mid) >= 32.0 else (lo, mid)
        want = 1.0 if ess_at(1.0) >= 32.0 else float(lo)
        assert beta < got < 1.0
        assert abs(got - want) <= 2e-5  # the bracket at the end: a comparison at the threshold may flip
        assert abs(float(smc._ess((got - beta) * _t(loglik))) - 32.0) < 0.05


def test_diagnostics_are_the_jax_packages():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(200, 3, 4)).cumsum(0) * 0.1 + rng.normal(size=(200, 3, 4))
    np.testing.assert_array_equal(diagnostics.effective_sample_size(x), jax_diag.effective_sample_size(x))
    np.testing.assert_array_equal(diagnostics.split_rhat(x), jax_diag.split_rhat(x))


# -- replayed transitions --------------------------------------------------------


@pytest.mark.parametrize("cross_chain", [True, False])
def test_hmc_iterations_match_jax_on_its_draws(cross_chain):
    init = np.random.default_rng(8).normal(size=(4, 2)).astype(np.float32)
    cfg = jax_hmc.HMCConfig(num_results=3, num_burnin=3, num_leapfrog=4, step_size=0.4,
                            num_adaptation=4, cross_chain_adapt=cross_chain)
    key = jax.random.PRNGKey(11)
    want, dj = jax_hmc.hmc_sample(_gauss_jax, jnp.asarray(init), key, cfg)
    keys = JaxSamplerKeys(key)
    got, dt = hmc.hmc_sample(_gauss_torch, _t(init), keys, hmc.HMCConfig(**cfg._asdict()))
    assert len(keys.margins) == 4 * 6 and min(keys.margins) > MARGIN
    np.testing.assert_allclose(_n(got), np.asarray(want), atol=POS_ATOL)
    for k in ("accept_rate", "final_step_size", "final_step_size_per_chain", "final_state"):
        np.testing.assert_allclose(_n(dt[k]), np.asarray(dj[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert 0.3 < float(dt["accept_rate"]) < 1.0


def test_nuts_transitions_match_jax_on_its_draws(uturn_margins):
    init = np.random.default_rng(9).normal(size=(4, 2)).astype(np.float32)
    inv_mass = np.array([1.2, 0.6], np.float32)
    cfg = jax_nuts.NUTSConfig(num_results=3, num_burnin=0, step_size=0.3, max_depth=6)
    key = jax.random.PRNGKey(5)
    want, dj = jax_nuts.nuts_sample(_gauss_jax, jnp.asarray(init), key, cfg, inv_mass0=jnp.asarray(inv_mass))
    keys = JaxSamplerKeys(key)
    uturn_margins.keys = keys
    got, dt = nuts.nuts_sample(_gauss_torch, _t(init), keys, nuts.NUTSConfig(**cfg._asdict()),
                               inv_mass0=_t(inv_mass))
    assert len(keys.margins) > 40 and min(keys.margins) > MARGIN, min(keys.margins)
    assert len(uturn_margins) > 20 and min(uturn_margins) > MARGIN, min(uturn_margins)
    np.testing.assert_allclose(_n(got), np.asarray(want), atol=POS_ATOL)
    np.testing.assert_allclose(float(dt["accept_rate"]), float(dj["accept_rate"]), rtol=1e-5)


def test_nuts_warmup_adapts_as_jax_on_its_draws(uturn_margins):
    """Ten burn-in iterations: dual averaging every iteration, Welford from
    iteration 1 to 8, the mass installed at 9 with a dual-averaging restart."""
    init = np.random.default_rng(10).normal(size=(4, 2)).astype(np.float32)
    cfg = jax_nuts.NUTSConfig(num_results=1, num_burnin=10, step_size=0.5, max_depth=5,
                              welford_window=(0.1, 0.9))
    key = jax.random.PRNGKey(2)
    w0 = (jnp.zeros(()), jnp.zeros(2), jnp.zeros(2))
    want, dj = jax_nuts.nuts_sample(_gauss_jax, jnp.asarray(init), key, cfg, welford0=w0)
    keys = JaxSamplerKeys(key)
    uturn_margins.keys = keys
    got, dt = nuts.nuts_sample(_gauss_torch, _t(init), keys, nuts.NUTSConfig(**cfg._asdict()),
                               welford0=tuple(torch.zeros(s) for s in ((), 2, 2)))
    assert min(keys.margins) > MARGIN and min(uturn_margins) > MARGIN
    np.testing.assert_allclose(_n(got), np.asarray(want), atol=POS_ATOL)
    for k in ("final_step_size", "inv_mass", "final_state"):
        np.testing.assert_allclose(_n(dt[k]), np.asarray(dj[k]), rtol=1e-5, atol=POS_ATOL, err_msg=k)
    for name, a, b in zip(("count", "mean", "m2"), dt["welford"], dj["welford"]):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)
    for name, a, b in zip(("log_eps_avg", "h_avg", "da_m", "mu"), dt["da"], dj["da"]):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)
    assert float(dt["welford"][0]) == 8 * 4 and int(dt["da"][2]) == 0  # restarted at the install


def test_nan_energy_is_no_divergence_as_in_jax():
    """The reference's NaN-blind divergence test (ADVICE.md), kept on purpose:
    a leaf whose log-prob is NaN gets weight 0 and does not end the
    trajectory, in the port as in the JAX package."""
    init = np.array([[1.5, 0.0], [1.2, -0.3]], np.float32)
    cfg = jax_nuts.NUTSConfig(num_results=1, num_burnin=0, step_size=0.6, max_depth=4)
    key = jax.random.PRNGKey(8)
    want, dj = jax_nuts.nuts_sample(lambda z: jnp.where(z[0] < 2.0, _gauss_jax(z), jnp.nan),
                                    jnp.asarray(init), key, cfg)
    keys = JaxSamplerKeys(key)
    got, dt = nuts.nuts_sample(lambda z: torch.where(z[:, 0] < 2.0, _gauss_torch(z), torch.nan),
                               _t(init), keys, nuts.NUTSConfig(**cfg._asdict()))
    assert min(keys.margins) > MARGIN
    assert np.isfinite(_n(got)).all()
    np.testing.assert_allclose(_n(got), np.asarray(want), atol=POS_ATOL)
    np.testing.assert_allclose(float(dt["accept_rate"]), float(dj["accept_rate"]), rtol=1e-5)


def test_smc_stage_matches_jax_on_its_draws():
    obs = np.array([1.2, -0.4], np.float32)
    init = 2.0 * np.random.default_rng(11).normal(size=(16, 2)).astype(np.float32)
    cfg = jax_smc.SMCConfig(num_particles=16, num_stages=1, mutation_steps=3, num_leapfrog=4, step_size=0.5)
    key = jax.random.PRNGKey(7)
    want, dj = jax_smc.smc_sample(lambda z: -0.5 * jnp.sum(z * z) / 4.0,
                                  lambda z: -0.5 * jnp.sum((z - obs) ** 2), jnp.asarray(init), key, cfg)
    keys = JaxSamplerKeys(key, mutation_steps=cfg.mutation_steps)
    got, dt = smc.smc_sample(lambda z: -0.5 * (z * z).sum(-1) / 4.0,
                             lambda z: -0.5 * ((z - _t(obs)) ** 2).sum(-1), _t(init), keys,
                             smc.SMCConfig(**cfg._asdict()))
    assert len(keys.margins) == 16 * 3 and min(keys.margins) > MARGIN
    beta = float(dt["beta"])
    assert 0 < beta < 1 and abs(beta - float(dj["beta"])) <= 2e-5
    # the resampling's decisions: no resampling point within MARGIN of a weight boundary
    u0 = float(jax.random.uniform(jax.random.split(key, 3)[1], ()))
    log_w = beta * -0.5 * ((init.astype(np.float64) - obs) ** 2).sum(-1)
    cum = np.cumsum(np.exp(log_w - log_w.max()) / np.exp(log_w - log_w.max()).sum())
    assert np.abs((u0 + np.arange(16))[:, None] / 16 - cum[None]).min() > MARGIN
    np.testing.assert_allclose(_n(got), np.asarray(want), atol=1e-4)
    for k in ("log_evidence", "last_accept", "final_step_size", "stages_used"):
        np.testing.assert_allclose(_n(dt[k]), np.asarray(dj[k]), rtol=1e-4, atol=1e-5, err_msg=k)


# -- whole samplers: the port's own statistics ------------------------------------


def test_hmc_gaussian_moments():
    g = torch.Generator().manual_seed(0)
    init = torch.randn((32, 2), generator=g)
    samples, diag = hmc.hmc_sample(_gauss_torch, init, g,
                                   hmc.HMCConfig(num_results=600, num_burnin=300, num_leapfrog=8, step_size=0.3))
    flat = _n(samples).reshape(-1, 2)
    assert 0.4 < float(diag["accept_rate"]) <= 1.0
    np.testing.assert_allclose(flat.mean(0), _MEAN, atol=0.08)
    np.testing.assert_allclose(np.cov(flat.T), _COV, atol=0.15)


def test_nuts_gaussian_moments():
    g = torch.Generator().manual_seed(1)
    init = torch.randn((16, 2), generator=g)
    samples, diag = nuts.nuts_sample(_gauss_torch, init, g,
                                     nuts.NUTSConfig(num_results=400, num_burnin=200, step_size=0.2, max_depth=6))
    flat = _n(samples).reshape(-1, 2)
    assert 0.5 < float(diag["accept_rate"]) <= 1.0
    np.testing.assert_allclose(flat.mean(0), _MEAN, atol=0.1)
    np.testing.assert_allclose(np.cov(flat.T), _COV, atol=0.2)


def test_smc_gaussian_posterior():
    obs = torch.tensor([1.2, -0.4])
    post_var = 1.0 / (1.0 / 4.0 + 1.0)
    g = torch.Generator().manual_seed(2)
    particles, diag = smc.smc_sample(lambda z: -0.5 * (z * z).sum(-1) / 4.0,
                                     lambda z: -0.5 * ((z - obs) ** 2).sum(-1),
                                     2.0 * torch.randn((2048, 2), generator=g), g,
                                     smc.SMCConfig(num_particles=2048, num_stages=15, step_size=0.5))
    assert float(diag["beta"]) == pytest.approx(1.0, abs=1e-4)
    np.testing.assert_allclose(_n(particles.mean(0)), post_var * _n(obs), atol=0.12)
    np.testing.assert_allclose(_n(particles.var(0)), post_var, rtol=0.3)


def test_chunked_nuts_is_one_call():
    """Two chunks threading step_size0, welford0 and da0 make the one call
    of twice the burn-in on the same draw stream (tests/test_mcmc.py:226)."""
    scales = torch.tensor([1.0, 0.05])
    lp = lambda x: -0.5 * ((x / scales) ** 2).sum(-1)
    init = torch.randn((8, 2), generator=torch.Generator().manual_seed(1)) * scales
    zeros = (torch.zeros(()), torch.zeros(2), torch.zeros(2))

    def cfg(n):
        return nuts.NUTSConfig(num_results=0, num_burnin=n, step_size=0.02, max_depth=6, adapt_mass=True,
                               welford_window=(0.0, 1.0), install_mass=False)

    _, whole = nuts.nuts_sample(lp, init, torch.Generator().manual_seed(3), cfg(40), welford0=zeros)
    g = torch.Generator().manual_seed(3)
    _, d = nuts.nuts_sample(lp, init, g, cfg(20), welford0=zeros)
    _, d = nuts.nuts_sample(lp, d["final_state"], g, cfg(20), step_size0=d["final_step_size"],
                            welford0=d["welford"], da0=d["da"])
    np.testing.assert_allclose(_n(d["final_state"]), _n(whole["final_state"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(d["final_step_size"]), float(whole["final_step_size"]), rtol=1e-5)
    for a, b in zip(d["welford"] + d["da"], whole["welford"] + whole["da"]):
        np.testing.assert_allclose(_n(a), _n(b), rtol=1e-5, atol=1e-6)
    count = float(d["welford"][0])
    assert count == 40 * 8
    var = _n(d["welford"][2]) / (count - 1.0)
    assert 1 / 3 < var[0] < 3.0 and 1 / 3 < var[1] / 0.05**2 < 3.0, var


# -- run_toy_mcmc and cli mcmc -----------------------------------------------------


@pytest.fixture
def toy_run(tmp_path):
    theta, mask, meas = _toy_inputs()
    run = tmp_path / "toy_run"
    run.mkdir()
    np.save(run / "all_masks.npy", mask[None])
    np.save(run / "all_proj_samples.npy", meas[None])
    return run


@pytest.mark.parametrize("sampler", ["hmc", "nuts", "smc"])
def test_run_toy_mcmc_writes_what_jax_writes(toy_run, tmp_path, sampler):
    import shutil

    from ct_pvae_tpu.eval.mcmc_run import run_toy_mcmc as jax_run_toy
    from ct_pvae_tpu_torch.eval.mcmc_run import run_toy_mcmc

    jax_dir = tmp_path / "jax"
    shutil.copytree(toy_run, jax_dir)
    kw = dict(number_of_steps=120, burnin=40, num_chains=4, sampler=sampler)
    want = jax_run_toy(str(jax_dir), **kw)
    got = run_toy_mcmc(str(toy_run), device="cpu", **kw)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert sorted(os.listdir(toy_run)) == sorted(os.listdir(jax_dir))
    assert np.load(toy_run / "posterior_prob_trace.npy").shape == (want.size // 4, 4)


def test_cli_mcmc_toy_on_the_cpu(toy_run, capsys):
    rc = cli.main(["mcmc", "--save_path", str(toy_run), "-s", "80", "-b", "40", "--chains", "4",
                   "--sampler", "nuts", "--device", "cpu"])
    assert rc == 0
    trace = np.load(toy_run / "posterior_prob_trace.npy")
    assert trace.shape == (80, 4) and np.isfinite(trace).all()
    assert "nuts done" in capsys.readouterr().out
