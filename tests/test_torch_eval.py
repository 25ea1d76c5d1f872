"""The port's evaluation stage and the rest of data generation against the JAX
package's, on the same numpy inputs: per-example FBP angles, merit, the
visualisation panels, the pixel histograms' draws and the analytic toy
posterior, fidelity, dataset panels, box plots, continuous toy images and
real-data ingest, and each new CLI subcommand on the CPU.

Random draws are made equal on both sides: the JAX package's key tree is
replayed into the port (``tests/_torch_parity.py``), and the Poisson
re-noising is replaced on both sides by one numpy draw (``jax.random.poisson``
here, in the test, and the port's named helper ``poisson_measurements``).
"""

import contextlib
import io
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_draws
from ct_pvae_tpu import cli as jax_cli
from ct_pvae_tpu.config import Config as JaxConfig
from ct_pvae_tpu.data import io as jax_io
from ct_pvae_tpu.data.sinogram import images_to_sinograms as jax_sinograms
from ct_pvae_tpu.vi.train import Trainer as JaxTrainer
from ct_pvae_tpu_torch import cli
from ct_pvae_tpu_torch.config import Config
from ct_pvae_tpu_torch.data.foam import generate_foam_images
from ct_pvae_tpu_torch.eval import fidelity, merit, pixel_dist, visualize
from ct_pvae_tpu_torch.ops import fbp as fbp_mod
from ct_pvae_tpu_torch.prob.distributions import EPS
from ct_pvae_tpu_torch.vi.loss import Draws
from ct_pvae_tpu_torch.vi.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
MERIT_RTOL = 1e-4


def _numpy_poisson(seed):
    """One noise draw in numpy for both packages, in place of the Poisson
    draw: jax.random.poisson's replacement (counts of ``lam``) and the
    port's ``poisson_measurements`` (rate x * pnm in float32, counts / pnm),
    as each package computes them.  The counts are lam + sqrt(lam) z on
    fixed standard normals z: continuous in lam, so rates that the two
    packages' projectors make equal to float32 rounding give counts equal to
    rounding (a true Poisson draw flips whole counts on such differences)."""
    def counts(lam):
        lam = np.asarray(lam, np.float64)
        return lam + np.sqrt(np.maximum(lam, 0.0)) * np.random.default_rng(seed).standard_normal(lam.shape)

    def jax_side(key, lam, shape=None, dtype=None):
        return jnp.asarray(counts(lam), jnp.float32)

    def port_side(x, pnm, gen):
        return torch.as_tensor(counts((x * pnm).cpu().numpy()), dtype=torch.float32, device=x.device) / pnm

    return jax_side, port_side


def _files(path):
    return sorted(os.listdir(path))


# -- the per-example FBP route ------------------------------------------------------------


def test_fbp_per_example_theta_is_a_loop_and_jax_vmap():
    from ct_pvae_tpu.ops.fbp import fbp as jax_fbp

    rng = np.random.default_rng(0)
    sino = rng.uniform(0, 2, (3, 5, 26)).astype(np.float32)
    theta = np.sort(rng.uniform(0, np.pi, (3, 5)), axis=1).astype(np.float32)
    got = fbp_mod.fbp(torch.as_tensor(sino), torch.as_tensor(theta), 26, 26)
    loop = torch.stack([fbp_mod.fbp(torch.as_tensor(sino[i]), torch.as_tensor(theta[i]), 26, 26)
                        for i in range(3)])
    np.testing.assert_array_equal(got.numpy(), loop.numpy())
    want = jax.jit(jax.vmap(lambda s, t: jax_fbp(s, t, 26, 26, "ramp")))(sino, theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="per-example theta"):
        fbp_mod.fbp(torch.as_tensor(sino), torch.as_tensor(theta[:2]), 26, 26)


def test_per_example_theta_never_reaches_kernel_d(monkeypatch):
    """D's route takes one shared (A,) angle set only; with the device check
    passed on the CPU, a 2-D theta at 512 bins still takes the gather route
    (D raises here), and a 1-D one takes D."""
    cuda = torch.device("cuda")
    assert fbp_mod.kernel_d_route(np.zeros(4), 728, 512, 512, cuda)
    assert not fbp_mod.kernel_d_route(np.zeros((2, 4)), 728, 512, 512, cuda)
    assert not fbp_mod.kernel_d_route(np.zeros(4), 728, 512, 512, CPU)
    assert not fbp_mod.kernel_d_route(np.zeros(4), 184, 128, 128, cuda)
    route = fbp_mod.kernel_d_route
    monkeypatch.setattr(fbp_mod, "kernel_d_route", lambda th, p, x, y, dev: route(th, p, x, y, cuda))
    calls = []

    def kernel_d(flat, theta, x, y):
        calls.append(theta)
        raise RuntimeError("kernel D reached")

    monkeypatch.setattr(fbp_mod, "backproject_static", kernel_d)
    rng = np.random.default_rng(1)
    sino = torch.as_tensor(rng.uniform(0, 1, (2, 3, 512)).astype(np.float32))
    theta = torch.as_tensor(rng.uniform(0, np.pi, (2, 3)).astype(np.float32))
    got = fbp_mod.fbp(sino, theta, 16, 16)
    want = torch.stack([fbp_mod.fbp(sino[i][None], theta[i][None], 16, 16)[0] for i in range(2)])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not calls
    with pytest.raises(RuntimeError, match="kernel D reached"):
        fbp_mod.fbp(sino, theta[0], 16, 16)
    assert len(calls) == 1


# -- merit --------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def merit_data():
    n, n_pix, n_ang, nsa = 5, 24, 30, 5
    imgs = generate_foam_images(n, n_pixel=n_pix, seed=0)
    theta = np.linspace(0, np.pi, n_ang, endpoint=False).astype(np.float32)
    sinos = np.asarray(jax_sinograms(imgs, theta, pad=True, batch=n))
    rng = np.random.default_rng(2)
    masks = np.zeros((n, n_ang), np.float32)
    for i in range(n):
        masks[i, rng.permutation(n_ang)[:nsa]] = 1.0 / nsa
    partial = (rng.poisson(sinos * masks[:, :, None] * 1e4) / 1e4).astype(np.float32)
    recon = np.clip(imgs + rng.normal(0, 0.05, imgs.shape), 0, None).astype(np.float32)[..., None]
    return dict(imgs=imgs, theta=theta, sinos=sinos, masks=masks, partial=partial, recon=recon,
                mean=imgs[..., None] * 0.9)


@pytest.mark.parametrize("baseline", ["fbp", "gridrec"])
def test_final_merit_matches_jax(merit_data, baseline, tmp_path, monkeypatch):
    from ct_pvae_tpu.eval.merit import final_merit as jax_final_merit

    d = merit_data
    jax_side, port_side = _numpy_poisson(3)
    monkeypatch.setattr(jax.random, "poisson", jax_side)
    monkeypatch.setattr(merit, "poisson_measurements", port_side)
    args = (d["imgs"], d["sinos"], d["masks"], d["partial"], d["recon"], d["theta"], 1e4)
    want = jax_final_merit(*args, save_path=str(tmp_path / "jax"), batch=4,
                           reconstruction_mean=d["mean"], baseline_alg=baseline)
    got = merit.final_merit(*args, save_path=str(tmp_path / "port"), batch=4,
                            reconstruction_mean=d["mean"], baseline_alg=baseline, device="cpu")
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, want, rtol=MERIT_RTOL)
    assert got[0, 2] > got[1, 2]  # full beats partial
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    suffix = "" if baseline == "fbp" else "_gridrec"
    np.testing.assert_array_equal(np.load(tmp_path / "port" / f"final_ave_merit{suffix}.npy"), got)
    np.testing.assert_allclose(np.load(tmp_path / "port" / "final_ave_merit_mean.npy"),
                               np.load(tmp_path / "jax" / "final_ave_merit_mean.npy"), rtol=MERIT_RTOL)


def test_cli_merit_writes_what_the_jax_cli_writes(merit_data, tmp_path, monkeypatch, capsys):
    d = merit_data
    ds = tmp_path / "dataset_m"
    jax_io.save_dataset(str(ds), d["sinos"], d["theta"], 24, 24)
    jax_io.save_ground_truth(d["imgs"], "m", str(tmp_path))
    for side in ("jax", "port"):
        run = tmp_path / side
        run.mkdir()
        np.save(run / "all_masks.npy", d["masks"])
        np.save(run / "all_proj_samples.npy", d["partial"])
        np.save(run / "reconstruction_final.npy", d["recon"])
        np.save(run / "reconstruction_mean.npy", d["mean"])
    jax_side, port_side = _numpy_poisson(4)
    monkeypatch.setattr(jax.random, "poisson", jax_side)
    monkeypatch.setattr(merit, "poisson_measurements", port_side)
    for alg in ("fbp", "gridrec_fourier"):
        flags = ["--input_path", str(ds), "--pnm", "1e4", "--baseline_alg", alg]
        assert jax_cli.main(["merit", "--save_path", str(tmp_path / "jax"), *flags]) == 0
        assert cli.main(["merit", "--save_path", str(tmp_path / "port"), *flags, "--device", "cpu"]) == 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for name in ("final_ave_merit.npy", "final_ave_merit_gridrec.npy", "final_ave_merit_mean.npy"):
        np.testing.assert_allclose(np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name),
                                   rtol=MERIT_RTOL, err_msg=name)
    out = capsys.readouterr().out
    assert out.count("P-VAE from noisy, partial sinogram") == 4 and out.count("P-VAE posterior mean") == 4


# -- visualize ----------------------------------------------------------------------------


VIS_N, VIS_PIX, VIS_ANGLES = 4, 16, 12


@pytest.fixture(scope="module")
def vis_run(tmp_path_factory):
    """A tiny foam run (16^2 foams, 26 bins, 12 angles, narrow width) the
    port trained for 2 steps on the CPU, with its masks, measurements, init
    stack and checkpoint; and the JAX package's visualize_run on a copy."""
    from ct_pvae_tpu.eval.visualize import visualize_run as jax_visualize_run

    root = tmp_path_factory.mktemp("vis")
    imgs = generate_foam_images(VIS_N, n_pixel=VIS_PIX, seed=3)
    theta = np.linspace(0, np.pi, VIS_ANGLES, endpoint=False).astype(np.float32)
    ds = root / "dataset_vis"
    jax_io.save_dataset(str(ds), np.asarray(jax_sinograms(imgs, theta, pad=True, batch=VIS_N)), theta,
                        VIS_PIX, VIS_PIX)
    jax_io.save_ground_truth(imgs, "vis", str(root))
    kw = dict(input_path=str(ds), save_path=str(root / "jax"), train=True, truncate_dataset=VIS_N,
              batch_size=2, num_sparse_angles=3, angles_per_iter=3, random_angles=True,
              num_samples=2, poisson_noise_multiplier=1e4, num_iter=2, num_blocks=2,
              num_feature_maps=4, intermediate_layers=1, use_normal=True, seed=5, example_num=1)
    tr = Trainer(Config(**kw), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tr.metrics, "save_plots", lambda: None)
        tr.train()
    shutil.copytree(root / "jax", root / "port")
    cfg = Config(**kw).replace(train=False)
    port_tr = Trainer(cfg.replace(save_path=str(root / "port"), restore=True, use_latest_ckpt=True),
                      device="cpu")
    shapes, out_shape = port_tr.draw_shapes(cfg.batch_size)
    draws = jax_draws(jax.random.PRNGKey(cfg.seed + 11), shapes, out_shape, cfg.num_samples)
    jax_side, _ = _numpy_poisson(6)
    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(printed):
        mp.setattr(jax.random, "poisson", jax_side)
        want = jax_visualize_run(JaxConfig(**kw).replace(train=False))
    step = {k: float(v) for k, v in (line.split() for line in printed.getvalue().splitlines()[:3])}
    return dict(root=root, cfg=cfg, trainer=port_tr, draws=draws, want=want, step=step, kw=kw)


def test_visualize_run_matches_jax(vis_run, monkeypatch, capsys):
    _, port_side = _numpy_poisson(6)
    monkeypatch.setattr(visualize, "poisson_measurements", port_side)
    cfg = vis_run["cfg"].replace(save_path=str(vis_run["root"] / "port"))
    got = visualize.visualize_run(cfg, trainer=vis_run["trainer"], device="cpu", draws=vis_run["draws"])
    want = vis_run["want"]
    assert sorted(got) == sorted(want) == ["full", "partial", "pvae", "pvae_mean"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    pngs = lambda side: [f for f in _files(vis_run["root"] / side) if f.endswith(".png")]
    assert pngs("port") == pngs("jax") == sorted(f"{name}.png" for name, _, _ in visualize.PANELS)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("loss_M_VAE ") and lines[1].startswith("kl_divergence ")


def test_visualize_arrays_eval_step_is_jaxs(vis_run):
    """The eval step's loss, KL and log-likelihood against those the JAX
    package's visualize_run printed, on the same draws; the panels' shapes."""
    got = visualize.visualize_arrays(vis_run["cfg"], vis_run["trainer"], vis_run["draws"])
    assert sorted(vis_run["step"]) == ["kl_divergence", "loglik", "loss_M_VAE"]
    for k, want in vis_run["step"].items():
        np.testing.assert_allclose(got[k], want, rtol=1e-4, err_msg=k)
    n_det = vis_run["trainer"].n_det
    assert got["ActualSinogramNoisy"].shape == got["ComputedSinogram"].shape == (VIS_ANGLES, n_det)
    assert got["ReconFromPVAE"].shape == got["GroundTruth"].shape == (VIS_PIX, VIS_PIX)


def test_cli_visualize_writes_the_jax_panels(vis_run, tmp_path):
    run = tmp_path / "run"
    shutil.copytree(vis_run["root"] / "port", run)
    for f in os.listdir(run):
        if f.endswith(".png"):
            os.remove(run / f)
    flags = ["--input_path", vis_run["kw"]["input_path"], "--save_path", str(run), "--td", "4", "-b", "2",
             "--nsa", "3", "--api", "3", "--random", "--ns", "2", "--pnm", "1e4", "--nb", "2",
             "--nfm", "4", "--il", "1", "--normal", "--seed", "5", "--en", "1", "--device", "cpu"]
    assert cli.main(["visualize", *flags]) == 0
    assert [f for f in _files(run) if f.endswith(".png")] == \
        [f for f in _files(vis_run["root"] / "jax") if f.endswith(".png")]


# -- pixel_dist and the analytic toy posterior --------------------------------------------


def test_analytic_discrete_posterior_matches_jax():
    from ct_pvae_tpu.mcmc.toy_model import analytic_discrete_posterior as jax_post
    from ct_pvae_tpu_torch.mcmc.toy_model import analytic_discrete_posterior

    rng = np.random.default_rng(7)
    for pnm in (1e3, 1e4):
        s0, s1 = rng.uniform(0.1, 1, (2, 2, 2)).astype(np.float32)
        mask = np.array([1.0, 0.0], np.float32)
        proj = (rng.poisson(s0 * mask[:, None] * pnm) / pnm).astype(np.float32)
        want = jax_post(jnp.asarray(proj), jnp.asarray(mask), jnp.asarray(s0), jnp.asarray(s1), pnm)
        got = analytic_discrete_posterior(*(torch.as_tensor(a) for a in (proj, mask, s0, s1)), pnm)
        np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=0, atol=1e-6)
        assert abs(float(got[0]) + float(got[1]) - 1.0) < 1e-6


PIX_R, PIX_S1, PIX_SEED = 6, 5, 17


class JaxPixelDraws:
    """The draws of JAX's ``collect_pixel_samples``: repeat r's key is the
    r-th split of PRNGKey(seed), split into the eval step's key and the
    output draws' key.  A per-repeat call (one repeat, the batch) takes
    repeat r's draws whole; a chunked call (a copy a repeat) takes element
    0 of each repeat's draws, the element the JAX package keeps."""

    def __init__(self, seed, num_repeats, shapes, out_shape, num_samples, num_samples_1):
        self.eval, self.u = [], []
        for key in jax.random.split(jax.random.PRNGKey(seed), num_repeats):
            k1, k2 = jax.random.split(key)
            self.eval.append(jax_draws(k1, shapes, out_shape, num_samples))
            u = jax.random.uniform(k2, (num_samples_1,) + out_shape, jnp.float32, minval=EPS,
                                   maxval=1.0 - EPS)
            self.u.append(torch.from_numpy(np.array(u)))

    def eval_draws(self, first, n, batch):
        if n == 1 and batch == self.eval[first].u[0].shape[0]:
            return self.eval[first]
        reps = self.eval[first:first + n]
        eps = [[torch.cat([r.eps[s][lv][:1] for r in reps]) for lv in range(len(reps[0].eps[s]))]
               for s in range(len(reps[0].eps))]
        return Draws(eps, [torch.cat([r.u[s][:1] for r in reps]) for s in range(len(reps[0].u))])

    def output(self, dist, first, n, num_samples_1):
        if n == 1 and dist.loc.shape[0] == self.u[first].shape[1]:
            return dist.sample(self.u[first])
        return dist.sample(torch.cat([u[:, :1] for u in self.u[first:first + n]], dim=1))


@pytest.fixture(scope="module")
def toy_run(tmp_path_factory):
    """The toy recipe (configs/toy.yaml, 8 sinograms) of the JAX Trainer at
    its initial params, checkpointed, and the JAX package's pixel samples
    and pixel_dist_run on it."""
    from ct_pvae_tpu.eval.pixel_dist import collect_pixel_samples as jax_collect
    from ct_pvae_tpu.eval.pixel_dist import pixel_dist_run as jax_pixel_dist_run

    root = tmp_path_factory.mktemp("pix")
    toy = os.path.join(REPO, "dataset_toy_discrete2")
    kw = {**Config.load(os.path.join(REPO, "configs", "toy.yaml")).to_dict(), "input_path": toy,
          "save_path": str(root / "jax"), "truncate_dataset": 8, "num_iter": 2}
    jtr = JaxTrainer(JaxConfig(**kw))
    jtr.checkpoint()
    want = jax_collect(jtr, 0, PIX_R, PIX_S1, seed=PIX_SEED)
    shutil.copytree(root / "jax", root / "port")
    # JAX's run reads these 3 x 4 draws from its cache (drawing anew compiles again)
    np.save(root / "jax" / "all_reconstructions_0.npy", want[:12])
    jax_samples, jax_h = jax_pixel_dist_run(JaxConfig(**kw).replace(train=False), trainer=jtr,
                                            num_repeats=3, num_samples_1=4)
    cfg = Config(**kw).replace(save_path=str(root / "port"), train=False, restore=True,
                               use_latest_ckpt=True)
    return dict(root=root, cfg=cfg, trainer=Trainer(cfg, device="cpu"), want=want, jax_h=jax_h,
                jax_samples=jax_samples)


def test_collect_pixel_samples_matches_jax_and_chunks(toy_run):
    tr, cfg = toy_run["trainer"], toy_run["cfg"]
    shapes, out_shape = tr.draw_shapes(cfg.batch_size)
    draws = JaxPixelDraws(PIX_SEED, PIX_R, shapes, out_shape, cfg.num_samples, PIX_S1)
    per_repeat = pixel_dist.collect_pixel_samples(tr, 0, PIX_R, PIX_S1, repeats_per_call=None,
                                                  draws=draws)
    assert per_repeat.shape == toy_run["want"].shape == (PIX_R * PIX_S1, 4)
    np.testing.assert_allclose(per_repeat, toy_run["want"], rtol=0, atol=1e-5)
    chunked = pixel_dist.collect_pixel_samples(tr, 0, PIX_R, PIX_S1, repeats_per_call=4, draws=draws)
    np.testing.assert_allclose(chunked, per_repeat, rtol=0, atol=1e-6)
    # the generator's draws: finite, non-negative, seeded
    a = pixel_dist.collect_pixel_samples(tr, 0, PIX_R, PIX_S1, repeats_per_call=4)
    b = pixel_dist.collect_pixel_samples(tr, 0, PIX_R, PIX_S1, repeats_per_call=4)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and (a >= 0).all()


def test_pixel_dist_run_writes_what_jax_writes(toy_run):
    cfg = toy_run["cfg"]
    samples, (h0, h1) = pixel_dist.pixel_dist_run(cfg, trainer=toy_run["trainer"], num_repeats=3,
                                                  num_samples_1=4, device="cpu")
    assert samples.shape == toy_run["jax_samples"].shape == (12, 4)
    np.testing.assert_allclose([h0, h1], toy_run["jax_h"], rtol=0, atol=1e-6)
    assert abs(h0 + h1 - 1.0) < 1e-6
    assert _files(toy_run["root"] / "port") == _files(toy_run["root"] / "jax")
    assert "pixel_vae_true_exp_3_ex_0.png" in _files(toy_run["root"] / "port")
    # the cache is read back, not redrawn
    again, _ = pixel_dist.pixel_dist_run(cfg, trainer=toy_run["trainer"], num_repeats=1,
                                         num_samples_1=1, device="cpu")
    np.testing.assert_array_equal(again, samples)


def test_cli_train_visualize_and_pixel_dist(tmp_path, monkeypatch, capsys):
    """``train --visualize --pixel_dist`` on the toy recipe writes the
    panels, the histograms and the draws' cache after training."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["make-data", "--img-type", "toy", "-n", "8", "--device", "cpu"]) == 0
    rc = cli.main(["train", "--config", os.path.join(REPO, "configs", "toy.yaml"), "--input_path",
                   "dataset_toy_discrete2", "--save_path", "run", "--td", "8", "-i", "2",
                   "--visualize", "--pixel_dist", "--num_repeats", "5", "--ns1", "3",
                   "--device", "cpu"])
    assert rc == 0
    files = set(_files(tmp_path / "run"))
    want = {f"{name}.png" for name, _, _ in visualize.PANELS}
    want |= {f"pixel_vae_true_exp_{p}_ex_0.png" for p in range(4)} | {"all_reconstructions_0.npy"}
    assert want <= files
    assert np.load(tmp_path / "run" / "all_reconstructions_0.npy").shape == (15, 4)
    assert "Average loss final" in capsys.readouterr().out


# -- fidelity -----------------------------------------------------------------------------


def test_porosity_fidelity_is_bitwise_jaxs():
    from ct_pvae_tpu.eval.fidelity import porosity_fidelity as jax_porosity

    targets = np.array([0.1, 0.5, 0.9])
    assert fidelity.porosity_fidelity(targets, trials=2, seed=3) == jax_porosity(targets, trials=2, seed=3)


def _assert_close_tree(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close_tree(g, w, f"{path}/{i}")
    elif isinstance(want, str):
        assert got == want, path
    else:
        np.testing.assert_allclose(got, want, rtol=MERIT_RTOL, err_msg=path)


def test_recon_fidelity_matches_jax(monkeypatch):
    from ct_pvae_tpu.eval.fidelity import recon_fidelity as jax_recon_fidelity

    jax_side, port_side = _numpy_poisson(8)
    monkeypatch.setattr(jax.random, "poisson", jax_side)
    monkeypatch.setattr(fidelity, "poisson_measurements", port_side)
    kw = dict(num=8, n_pixel=32, num_angles=30, seed=1, batch=3)
    _assert_close_tree(fidelity.recon_fidelity(**kw, device="cpu"), jax_recon_fidelity(**kw))


def test_cli_fidelity_writes_what_the_jax_cli_writes(tmp_path, monkeypatch, capsys):
    """The subcommand's wiring and file; the two studies are held above."""
    import json

    from ct_pvae_tpu.eval import fidelity as jax_fidelity

    for mod in (fidelity, jax_fidelity):
        monkeypatch.setattr(mod, "porosity_fidelity", lambda seed: {"seed": seed})
    monkeypatch.setattr(fidelity, "recon_fidelity",
                        lambda num, seed, device: {"num": num, "seed": seed, "device": device})
    monkeypatch.setattr(jax_fidelity, "recon_fidelity", lambda num, seed: {"num": num, "seed": seed})
    assert cli.main(["fidelity", "-n", "3", "--seed", "2", "--out", str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    assert jax_cli.main(["fidelity", "-n", "3", "--seed", "2", "--out", str(tmp_path / "jax")]) == 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == ["fidelity.json"]
    with open(tmp_path / "port" / "fidelity.json") as f:
        assert json.load(f) == {"porosity": {"seed": 2}, "recon": {"num": 3, "seed": 2, "device": "cpu"}}
    with open(tmp_path / "jax" / "fidelity.json") as f:
        assert json.load(f) == {"porosity": {"seed": 2}, "recon": {"num": 3, "seed": 2}}


# -- box plots ----------------------------------------------------------------------------


def _trials(root, names, seed):
    """Runs holding random final_ave_merit.npy, as tests/test_merit.py builds them."""
    rng = np.random.default_rng(seed)
    paths = []
    for name in names:
        p = root / name
        p.mkdir()
        np.save(p / "final_ave_merit.npy", rng.uniform(0, 1, (3, 3)))
        paths.append(str(p))
    return paths


def test_boxplot_tables_are_jaxs(tmp_path):
    from ct_pvae_tpu.eval import boxplot as jax_boxplot
    from ct_pvae_tpu_torch.eval import boxplot

    paths = _trials(tmp_path, [f"trial{t}{s}" for t in range(3) for s in ("", "_uniform")], 0)
    rand, unif = paths[::2], paths[1::2]
    assert boxplot.pair_uniform_paths(rand) == jax_boxplot.pair_uniform_paths(rand) == unif
    r, u = boxplot.load_merits(rand), boxplot.load_merits(unif)
    np.testing.assert_array_equal(r, jax_boxplot.load_merits(rand))
    tab = boxplot.five_condition_table(r, u)
    np.testing.assert_array_equal(tab, jax_boxplot.five_condition_table(r, u))
    got, want = boxplot.median_trials(tab), jax_boxplot.median_trials(tab)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    solo = _trials(tmp_path, ["solo0", "solo1"], 1)
    assert boxplot.pair_uniform_paths(solo) is None is jax_boxplot.pair_uniform_paths(solo)
    even = boxplot.five_condition_table(r[:2], u[:2])
    assert all(len(v) == 0 for v in boxplot.median_trials(even).values())


@pytest.mark.parametrize("paired", [True, False])
def test_cli_boxplot_writes_what_the_jax_cli_writes(tmp_path, paired, capsys):
    names = [f"t{t}{s}" for t in range(3) for s in ("", "_uniform")] if paired else ["s0", "s1"]
    paths = _trials(tmp_path, names, 0)
    runs = paths[::2] if paired else paths
    assert jax_cli.main(["boxplot", "--save_paths", *runs, "--out", str(tmp_path / "jax")]) == 0
    jax_out = capsys.readouterr().out
    assert cli.main(["boxplot", "--save_paths", *runs, "--out", str(tmp_path / "port")]) == 0
    port_out = capsys.readouterr().out
    assert port_out == jax_out
    assert _files(tmp_path / "port") == sorted(_files(tmp_path / "jax") + ["medians.txt"])
    assert (tmp_path / "port" / "medians.txt").read_text() == jax_out
    assert ("median trial for" in jax_out) == paired


# -- dataset panels -----------------------------------------------------------------------


def test_visualize_dataset_panels_are_jaxs(tmp_path, capsys):
    """The JAX CLI's PNGs, pixel for pixel, from the fixture of tests/test_eval.py."""
    import matplotlib.image

    rng = np.random.default_rng(0)
    sinos = rng.uniform(0, 1, (3, 4, 8)).astype(np.float32)
    theta = np.linspace(0, np.pi, 4, endpoint=False).astype(np.float32)
    ds = str(tmp_path / "dataset_foo")
    jax_io.save_dataset(ds, sinos, theta, 6, 6)
    jax_io.save_ground_truth(rng.uniform(0, 1, (3, 6, 6)).astype(np.float32), "foo", str(tmp_path))
    for run in ("run_random", "run_uniform"):
        (tmp_path / run).mkdir()
        np.save(tmp_path / run / "all_proj_samples.npy", sinos / 2.0)
    flags = ["--input_path", ds, "--save_path_random", str(tmp_path / "run_random"),
             "--save_path_uniform", str(tmp_path / "run_uniform"), "--en", "1", "--nsa", "2"]
    assert jax_cli.main(["visualize-dataset", *flags, "--out", str(tmp_path / "jax")]) == 0
    assert cli.main(["visualize-dataset", *flags, "--out", str(tmp_path / "port")]) == 0
    names = _files(tmp_path / "jax")
    assert _files(tmp_path / "port") == names == [
        "full_sinogram_ex_1.png", "ground_truth_ex_1.png", "proj_random_ex_1.png", "proj_uniform_ex_1.png"]
    for name in names:
        np.testing.assert_array_equal(matplotlib.image.imread(tmp_path / "port" / name),
                                      matplotlib.image.imread(tmp_path / "jax" / name), err_msg=name)
    from ct_pvae_tpu_torch.eval.dataset_viz import dataset_panels

    panels = dataset_panels(ds, str(tmp_path / "run_random"), None, example_num=1, num_sparse_angles=2)
    assert sorted(panels) == ["full_sinogram", "ground_truth", "proj_random"]
    np.testing.assert_array_equal(panels["proj_random"][0], sinos[1])  # 2 x sinos / 2
    assert panels["proj_random"][1:] == (float(sinos[1].min()), float(sinos[1].max()))
    assert panels["ground_truth"][0].shape == (8, 8)


def test_figures_without_matplotlib_raise(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    from ct_pvae_tpu_torch.eval import boxplot

    paths = _trials(tmp_path, ["s0"], 0)
    with pytest.raises(ImportError, match="matplotlib"):
        boxplot.make_box_plots(paths, str(tmp_path / "out"))
    with pytest.raises(ImportError, match="matplotlib"):
        visualize.visualize_run(Config(save_path=str(tmp_path / "v")), device="cpu")
    final_vals, labels, lines = boxplot.box_plot_table(paths)  # the numbers need no matplotlib
    assert final_vals.shape == (1, 3, 3) and len(lines) == 3


# -- data generation ----------------------------------------------------------------------


def test_continuous_toy_images_draw_the_prior():
    from ct_pvae_tpu.data.toy import generate_toy_images as jax_toy
    from ct_pvae_tpu_torch.data.toy import generate_toy_images

    got = generate_toy_images(4000, discrete=False, seed=2)
    assert got.shape == (4000, 2, 2) and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got.reshape(4000, -1).sum(-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(got, generate_toy_images(4000, discrete=False, seed=2))
    assert not np.array_equal(got, generate_toy_images(4000, discrete=False, seed=3))
    # the JAX package draws the same prior with its own random numbers: the
    # pixel means agree to the sampling error (each pixel's sd <= 0.5)
    want = jax_toy(4000, discrete=False, seed=2)
    np.testing.assert_allclose(got.mean(0), want.mean(0), atol=5 * 0.5 / np.sqrt(4000))


def _write_h5(path, a=12, z=5, p=16, scale=1.0):
    """An exchange/data (A, Z, P) volume with exchange/theta, as tests/test_real_data.py writes."""
    import h5py

    with h5py.File(path, "w") as f:
        rng = np.random.default_rng(0)
        f["exchange/data"] = scale * rng.uniform(-0.1, 1, size=(a, z, p)).astype(np.float32)
        f["exchange/theta"] = np.linspace(0, np.pi, a, endpoint=False).astype(np.float32)


@pytest.mark.parametrize("slices", ["middle", "all", 3])
def test_preformat_h5_is_bitwise_jaxs(tmp_path, slices):
    pytest.importorskip("h5py")
    from ct_pvae_tpu.data.real import preformat_h5 as jax_preformat
    from ct_pvae_tpu_torch.data.real import preformat_h5

    d = tmp_path / "h5s"
    (d / "sub").mkdir(parents=True)
    _write_h5(d / "scan1.h5")
    _write_h5(d / "sub" / "scan2.h5", scale=3.0)
    _write_h5(d / "odd.h5", a=7)  # another angle count: skipped
    got = preformat_h5(str(d), str(tmp_path / "port"), slices=slices)
    want = jax_preformat(str(d), str(tmp_path / "jax"), slices=slices)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    for g, w in zip(jax_io.load_dataset(str(tmp_path / "port")), jax_io.load_dataset(str(tmp_path / "jax"))):
        np.testing.assert_array_equal(g, w)


def test_cli_make_data_h5_and_without_h5py(tmp_path, monkeypatch, capsys):
    pytest.importorskip("h5py")
    import sys

    d = tmp_path / "h5s"
    d.mkdir()
    _write_h5(d / "scan.h5")
    flags = ["make-data", "--h5-dir", str(d), "--slices", "all"]
    assert jax_cli.main([*flags, "--save-path", str(tmp_path / "jax")]) == 0
    assert cli.main([*flags, "--save-path", str(tmp_path / "port"), "--device", "cpu"]) == 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "x_train_sinograms.npy"),
                                  np.load(tmp_path / "jax" / "x_train_sinograms.npy"))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[2] == "Shape of sinograms: (5, 12, 16)"
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        cli.main([*flags, "--save-path", str(tmp_path / "none"), "--device", "cpu"])
