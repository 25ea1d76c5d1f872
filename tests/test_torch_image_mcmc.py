"""The port's image posterior (``ct_pvae_tpu_torch/mcmc/image_model.py``) and
``run_foam_mcmc`` against the JAX package on the CPU.

The 16^2 phantom and its masked Poisson measurement of
``tests/test_image_mcmc.py`` feed both sides as numpy arrays.  The gather
route is held against the JAX package's gather route, the Joseph route (the
plain version of kernels A and B on the CPU) against its Pallas route in
interpret mode at 64^2, the curvature against the JAX estimate on the same
Rademacher probes, and one NUTS transition against the JAX transition on
its own draws (``JaxSamplerKeys``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxSamplerKeys
from ct_pvae_tpu.config import Config as JaxConfig
from ct_pvae_tpu.data.recon_init import crop_center
from ct_pvae_tpu.eval import metrics as jax_metrics
from ct_pvae_tpu.eval.mcmc_run import run_foam_mcmc as jax_run_foam
from ct_pvae_tpu.mcmc import image_model as jim
from ct_pvae_tpu.mcmc import nuts as jax_nuts
from ct_pvae_tpu.ops.fbp import fbp as jax_fbp
from ct_pvae_tpu.ops.radon import num_proj_pixels
from ct_pvae_tpu.ops.radon import radon as jax_radon
from ct_pvae_tpu_torch import cli
from ct_pvae_tpu_torch.eval import metrics
from ct_pvae_tpu_torch.eval.mcmc_run import amplitude_corrected, run_foam_mcmc
from ct_pvae_tpu_torch.mcmc import image_model as im
from ct_pvae_tpu_torch.mcmc import nuts
from ct_pvae_tpu_torch.ops import joseph_radon, radon

H = 16
PNM = 1e4
MARGIN = 1e-4   # least distance of a replayed decision from its threshold
LP_RTOL = 1e-5  # log-prob values: float32 sums of a few hundred O(1) terms in another order
GRAD_TOL = 1e-4  # gradients, of the gradient's largest entry


def _phantom(n=H):
    c = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    xx, yy = np.meshgrid(c, c, indexing="ij")
    img = (np.hypot(xx, yy) <= 0.9).astype(np.float32)
    img[np.hypot(xx - 0.3, yy + 0.2) <= 0.3] = 0.0
    return img


@pytest.fixture(scope="module")
def meas():
    """(ground truth, theta, mask, measurements, n_det, partial FBP): the
    masked, dose-normalised, Poisson-noised sinogram of tests/test_image_mcmc.py."""
    rng = np.random.default_rng(0)
    gt = _phantom()
    theta = np.linspace(0, np.pi, 12, endpoint=False).astype(np.float32)
    n_det = num_proj_pixels(H, H)
    proj = np.asarray(jax_radon(jnp.asarray(gt[None]), jnp.asarray(theta), pad=True))[0]
    mask = np.zeros(12, np.float32)
    mask[::2] = 1.0 / 6
    m = rng.poisson(np.clip(proj * mask[:, None], 0, None) * PNM).astype(np.float32) / PNM
    unnorm = np.where(mask[:, None] > 0, m / np.maximum(mask[:, None], 1e-9), 0.0)
    rec = np.asarray(jax_fbp(jnp.asarray(unnorm[None]), jnp.asarray(theta), n_det, n_det, "ramp"))[0]
    return gt, theta, mask, m, n_det, np.asarray(crop_center(rec, H, H))


def _used(meas):
    gt, theta, mask, m, _, _ = meas
    used = mask > 0
    return m[used], theta[used], mask[used]


def _points(gt, chains, seed):
    x = np.asarray(im.softplus_inverse(torch.from_numpy(gt.reshape(-1) + 0.05)))
    return (x[None] + 0.3 * np.random.default_rng(seed).normal(size=(chains, x.size))).astype(np.float32)


def _value_and_grad_close(lp_t, lp_j, x):
    v, g = nuts.value_and_grad(lp_t, torch.from_numpy(x))
    vj, gj = jax.vmap(jax.value_and_grad(lp_j))(jnp.asarray(x))
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=LP_RTOL)
    gj = np.asarray(gj)
    np.testing.assert_allclose(g.numpy(), gj, rtol=0, atol=GRAD_TOL * np.abs(gj).max())


@pytest.mark.parametrize("prior", ["tv", "smooth", "flat"])
def test_image_log_prob_and_gradient_match_jax(meas, prior):
    m, theta, mask = _used(meas)
    calls = radon.CALLS["radon"]
    lp_t = im.make_image_log_prob(m, theta, mask, PNM, H, H, prior=prior, prior_weight=10.0)
    lp_j = jim.make_image_log_prob(m, theta, mask, PNM, H, H, prior=prior, prior_weight=10.0)
    _value_and_grad_close(lp_t, lp_j, _points(meas[0], 3, 1))
    assert radon.CALLS["radon"] == calls + 1  # the gather route, one batched call for 3 chains


def test_joseph_route_matches_jax_pallas_route():
    """64^2, 8 angles: n_det >= 64 takes the Joseph route (A's and B's plain
    versions here), held against the JAX package's Pallas route in interpret
    mode, and within 2e-2 of the gather route (tests/test_image_mcmc.py:136)."""
    n = 64
    gt = _phantom(n)
    theta = np.linspace(0, np.pi, 8, endpoint=False).astype(np.float32)
    mask = np.full(8, 1.0 / 8, np.float32)
    m = np.asarray(jax_radon(jnp.asarray(gt[None]), jnp.asarray(theta), pad=True))[0] * mask[:, None]
    kw = dict(poisson_noise_multiplier=PNM, x_size=n, y_size=n, prior="tv", prior_weight=1.0)
    assert im.Projector(theta, n, n, m.shape[-1]).joseph
    lp_t = im.make_image_log_prob(m, theta, mask, **kw)
    lp_j = jim.make_image_log_prob(m, theta, mask, use_pallas=True, interpret=True, **kw)
    x = _points(gt, 2, 2)
    calls = radon.CALLS["radon"]
    _value_and_grad_close(lp_t, lp_j, x)
    assert radon.CALLS["radon"] == calls
    gather = im.make_image_log_prob(m, theta, mask, use_pallas=False, **kw)(torch.from_numpy(x))
    joseph = lp_t(torch.from_numpy(x))
    assert (torch.abs(joseph - gather) / gather.abs()).max() < 2e-2


def test_rate_floor_matches_jax(meas):
    """The reference's 1e-30 rate floor (ADVICE.md), kept on purpose: where
    photons were counted but the image projects to 0, the floored rate
    makes log1p's argument -1 in float32, so the log-prob is -inf and its
    gradient NaN, in the port as in the JAX package (``torch.clamp`` alone
    would give a finite gradient there)."""
    m, theta, mask = _used(meas)
    x = _points(meas[0], 2, 7) - 120.0  # softplus underflows: every rate at the floor
    lp_t = im.make_image_log_prob(m, theta, mask, PNM, H, H, prior="flat")
    lp_j = jim.make_image_log_prob(m, theta, mask, PNM, H, H, prior="flat")
    v, g = nuts.value_and_grad(lp_t, torch.from_numpy(x))
    vj, gj = jax.vmap(jax.value_and_grad(lp_j))(jnp.asarray(x))
    assert np.isneginf(v.numpy()).all() and np.isneginf(np.asarray(vj)).all()
    assert np.isnan(g.numpy()).any()
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-6, equal_nan=True)


def test_positive_median_is_jnp_nanmedian():
    rng = np.random.default_rng(3)
    for size in (9, 10, 1):
        v = rng.normal(size=size).astype(np.float32)
        v[0] = abs(v[0])
        want = float(jnp.nanmedian(jnp.where(v > 0, v, jnp.nan)))
        assert float(im.positive_median(torch.from_numpy(v))) == pytest.approx(want, rel=1e-7)
    assert float(im.positive_median(-torch.ones(4))) == 1.0
    v = torch.tensor([3.0, 1.0, -2.0, 2.0, 4.0])  # positives 1 2 3 4: torch.nanmedian gives 2
    assert float(im.positive_median(v)) == 2.5


@pytest.mark.parametrize("route", ["gather", "joseph"])
def test_curvature_matches_jax_on_the_same_probes(meas, route):
    if route == "gather":
        m, theta, mask = _used(meas)
        n, prior = H, "tv"
    else:  # the Joseph route: 64^2 onto 94 bins, its adjoint kernel B's plain version
        n, prior = 64, "smooth"
        theta = np.linspace(0, np.pi, 6, endpoint=False).astype(np.float32)
        mask = np.full(6, 1.0 / 6, np.float32)
        m = np.asarray(jax_radon(jnp.asarray(_phantom(n)[None]), jnp.asarray(theta), pad=True))[0] * mask[:, None]
    x0 = _points(_phantom(n), 1, 4)[0]
    key = jax.random.PRNGKey(3)
    probes = np.stack([np.asarray(jax.random.rademacher(k, x0.shape, jnp.float32))
                       for k in jax.random.split(key, 16)])
    kw = dict(prior=prior, prior_weight=10.0, num_probes=16, use_pallas=route == "joseph")
    want = np.asarray(jim.estimate_curvature_diag(jnp.asarray(x0), m, theta, mask, PNM, n, n, key=key,
                                                  interpret=True, **kw))
    got = im.estimate_curvature_diag(torch.from_numpy(x0), m, theta, mask, PNM, n, n,
                                     probes=torch.from_numpy(probes), **kw).numpy()
    assert (got > 0).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_amplitude_correction_matches_jax(meas):
    m, theta, mask = _used(meas)
    init = meas[5]
    # eval/mcmc_run.py:243-250
    pos = jnp.clip(jnp.asarray(init), 0.0, None)
    pred = jax_radon(pos[None], jnp.asarray(theta), pad=True, n_det=int(m.shape[-1]))[0] * jnp.asarray(mask)[:, None]
    amp = float(np.clip(float(jnp.sum(jnp.asarray(m))) / float(jnp.sum(pred)), 1e-3, 1e3))
    got = amplitude_corrected(init, torch.from_numpy(m), theta, torch.from_numpy(mask))
    np.testing.assert_allclose(got, np.asarray(pos) * amp, rtol=1e-5, atol=1e-7)
    assert 1.0 < amp < 1e3


def test_nuts_transition_on_the_image_posterior_matches_jax(meas):
    """From a state that 30 warm-up iterations of the port's NUTS brought into
    the posterior's bulk, with the curvature metric: one transition of 2
    chains on the JAX transition's draws."""
    m, theta, mask = _used(meas)
    lp_t = im.make_image_log_prob(m, theta, mask, PNM, H, H)
    lp_j = jim.make_image_log_prob(m, theta, mask, PNM, H, H)
    gen = torch.Generator().manual_seed(0)
    init = im.softplus_inverse(torch.from_numpy(meas[0].reshape(-1) + 0.05)) + 0.05 * torch.randn((2, H * H), generator=gen)
    inv_mass = 1.0 / im.estimate_curvature_diag(init.mean(0), m, theta, mask, PNM, H, H, gen=gen)
    _, warm = nuts.nuts_sample(lp_t, init, gen, nuts.NUTSConfig(num_results=0, num_burnin=30, step_size=0.05,
                                                                max_depth=6, adapt_mass=False), inv_mass0=inv_mass)
    state, step = warm["final_state"].numpy(), float(warm["final_step_size"])
    cfg = jax_nuts.NUTSConfig(num_results=1, num_burnin=0, step_size=step, max_depth=6)
    key = jax.random.PRNGKey(5)
    want, dj = jax_nuts.nuts_sample(lp_j, jnp.asarray(state), key, cfg, inv_mass0=jnp.asarray(inv_mass.numpy()))
    keys = JaxSamplerKeys(key)
    got, dt = nuts.nuts_sample(lp_t, torch.from_numpy(state), keys, nuts.NUTSConfig(**cfg._asdict()),
                               inv_mass0=inv_mass)
    assert len(keys.margins) > 50 and min(keys.margins) > MARGIN, min(keys.margins)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(float(dt["accept_rate"]), float(dj["accept_rate"]), rtol=1e-4)
    assert np.abs(got.numpy() - state).max() > 1e-2  # the chains moved


def test_nuts_posterior_mean_beats_partial_fbp(meas):
    """The oracle of tests/test_image_mcmc.py:91-110 on the port's NUTS."""
    gt, _, _, _, _, init_recon = meas
    m, theta, mask = _used(meas)
    lp = im.make_image_log_prob(m, theta, mask, PNM, H, H, prior="tv", prior_weight=10.0)
    psnr_fbp = metrics.compare(gt, np.clip(init_recon, 0, 1))[2]
    gen = torch.Generator().manual_seed(1)
    init = im.init_chains_from_recon(init_recon, 4, gen)
    samples, diag = nuts.nuts_sample(lp, init, gen, nuts.NUTSConfig(num_results=40, num_burnin=40,
                                                                    step_size=1e-2, max_depth=6))
    post_mean = im.softplus_forward(samples).mean((0, 1)).reshape(H, H).numpy()
    psnr_mcmc = metrics.compare(gt, np.clip(post_mean, 0, 1))[2]
    assert np.isfinite(psnr_mcmc) and psnr_mcmc > psnr_fbp, (psnr_mcmc, psnr_fbp)
    assert float(diag["accept_rate"]) > 0.2


def test_ssim_and_compare_are_the_jax_packages(meas):
    gt, init = meas[0], meas[5]
    assert metrics.compare(gt, init) == jax_metrics.compare(gt, init)
    assert metrics.ssim(gt, init, 1.0, win_size=3) == jax_metrics.ssim(gt, init, 1.0, win_size=3)


def _run_dir(root, meas):
    gt, theta, mask, m, n_det, init = meas
    run, ds = root / "run", root / "dataset_tiny"
    run.mkdir(parents=True)
    ds.mkdir()
    np.save(ds / "x_train_sinograms.npy", m[None])
    np.save(ds / "dataset_parameters.npy", np.array([theta, float(n_det)], object), allow_pickle=True)
    np.save(root / "tiny_training.npy", gt[None])
    np.save(run / "all_masks.npy", mask[None])
    np.save(run / "all_proj_samples.npy", m[None])
    np.save(run / "all_input_encode.npy", init[None, :, :, None])
    np.save(run / "reconstruction_mean.npy", np.clip(init, 0, None)[None, :, :, None])
    JaxConfig(input_path=str(ds), save_path=str(run), poisson_noise_multiplier=PNM).save(str(run / "config.json"))
    return run


@pytest.mark.parametrize("sampler, kw", [
    ("nuts", dict(number_of_steps=6, burnin=12, chunk=4, max_depth=4)),
    ("hmc", dict(number_of_steps=4, burnin=4, chunk=4)),
    ("smc", dict(number_of_steps=40, chunk=32, smc_beta0=0.9, init_source="vae", output_prefix="smc")),
])
def test_run_foam_mcmc_writes_what_jax_writes(meas, tmp_path, sampler, kw):
    """``run_foam_mcmc``'s chunk schedule on a tiny run directory (NUTS: three
    warm-up chunks, so the Welford window and the mass install both fire;
    warm SMC from the VAE init): the same files and keys as the JAX package's."""
    run_j, run_t = _run_dir(tmp_path / "jax", meas), _run_dir(tmp_path / "torch", meas)
    want = jax_run_foam(str(run_j), num_chains=2, sampler=sampler, seed=0, **kw)
    got = run_foam_mcmc(str(run_t), num_chains=2, sampler=sampler, seed=0, device="cpu", **kw)
    assert sorted(os.listdir(run_t)) == sorted(os.listdir(run_j))
    assert sorted(got) == sorted(want) and sorted(got["diag"]) == sorted(want["diag"])
    assert got["mean"].shape == (H, H) and np.isfinite(got["mean"]).all() and (got["std"] >= 0).all()
    assert got["draws"] == want["draws"]
    assert np.isfinite(got["psnr_mcmc"]) and got["psnr_init"] == pytest.approx(want["psnr_init"], abs=1e-3)
    if sampler == "smc":
        assert got["diag"]["beta"] == 1.0
    else:
        assert got["diag"]["rhat_max"] >= 1.0 - 1e-6 and got["diag"]["ess_min"] > 0


def test_cli_mcmc_foam_on_the_cpu(meas, tmp_path, capsys):
    run = _run_dir(tmp_path, meas)
    rc = cli.main(["mcmc", "--model", "foam", "--save_path", str(run), "-s", "8", "-b", "8",
                   "--chains", "2", "--sampler", "nuts", "--prior", "smooth", "--prior_weight", "5.0",
                   "--device", "cpu"])
    assert rc == 0
    mean = np.load(run / "mcmc_posterior_mean.npy")
    assert mean.shape == (H, H) and np.isfinite(mean).all()
    assert "posterior-mean PSNR" in capsys.readouterr().out
    assert joseph_radon.LAUNCHES["joseph_fwd"] == 0
