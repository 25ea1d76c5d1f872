"""The port's serving slice end to end (``amortized_infer`` / ``cli infer``)
against the JAX package's, plus the port's import and device rules."""

import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_infer_finish as finish
from _torch_parity import JaxReplaySampler
from ct_pvae_tpu.config import Config as JaxConfig
from ct_pvae_tpu.vi.infer import amortized_infer as jax_amortized_infer
from ct_pvae_tpu.vi.train import Trainer
from ct_pvae_tpu_torch import cli
from ct_pvae_tpu_torch.config import Config
from ct_pvae_tpu_torch.ops.radon import num_proj_pixels
from ct_pvae_tpu_torch.vi.infer import amortized_infer
from ct_pvae_tpu_torch.vi.loss import GeneratorDraws
from ct_pvae_tpu_torch.vi.serve import Server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, A, P, BATCH, PASSES = 10, 30, 48, 4, 2
OVERRIDES = {"cheap_init": True, "real_data": True}


def _data():
    rng = np.random.default_rng(0)
    theta = np.sort(rng.uniform(0, np.pi, A)).astype(np.float32)
    return rng.uniform(0, 5, (N, A, P)).astype(np.float32), theta


def _trained_run(run_dir, sinos, theta):
    """A foam-shaped run (the paper's init algorithms and random sparse
    angles, narrow width): JAX Trainer init params saved by its checkpoint()."""
    cfg = JaxConfig(
        save_path=str(run_dir), train=True, truncate_dataset=N, batch_size=BATCH,
        num_sparse_angles=6, angles_per_iter=6, random_angles=True, num_samples=2,
        poisson_noise_multiplier=1e4, pnm_start=1e3, num_iter=100,
        algorithms=["sirt", "tv", "fbp", "gridrec"], num_blocks=2, num_feature_maps=4,
        intermediate_layers=1, kernel_size=4, intermediate_kernel=4, stride_encode=2,
        use_normal=True, cheap_init=True, real_data=True,
    )
    tr = Trainer(cfg, sinograms=sinos, theta=theta)
    tr.state = tr.state.replace(step=jnp.int32(37))  # mid-anneal
    tr.checkpoint()
    return cfg


def test_amortized_infer_matches_jax(tmp_path):
    sinos, theta = _data()
    run = tmp_path / "run"
    cfg = _trained_run(run, sinos, theta)
    ref = jax_amortized_infer(str(run), str(tmp_path / "jax"), sinograms=sinos, theta=theta,
                              num_passes=PASSES, overrides=OVERRIDES, seed=3)
    sampler = JaxReplaySampler(3, -(-N // BATCH), PASSES)
    out = amortized_infer(str(run), str(tmp_path / "torch"), sinograms=sinos, theta=theta,
                          num_passes=PASSES, overrides=OVERRIDES, seed=3, device="cpu",
                          sampler=sampler)
    x = int(np.floor(P / np.sqrt(2) - 2))
    for k in ("mean", "std", "sample"):
        assert out[k].shape == ref[k].shape == (N, x, x, 1), k
    np.testing.assert_allclose(out["mean"], ref["mean"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["sample"], ref["sample"], rtol=0, atol=1e-4)
    # std through the variance it is the root of: both sides form it as the
    # float32 moments E[m^2] - E[m]^2 of values near 0.5, whose absolute error
    # of a few 1e-8 the square root blows up to ~2e-4 where std is near 0
    var_o, var_r = out["std"].astype(np.float64) ** 2, ref["std"].astype(np.float64) ** 2
    np.testing.assert_allclose(var_o, var_r, rtol=0, atol=1e-6)
    # both ELBOs take the gather projector here (a 48-pixel detector, no mesh)
    assert out["loss"].shape == ref["loss"].shape and np.isfinite(out["loss"]).all()
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-4)
    for name in ("all_masks.npy", "all_proj_samples.npy", "all_input_encode_cheap.npy",
                 "reconstruction_mean.npy", "reconstruction_std.npy", "reconstruction_sample.npy",
                 "infer_loss.npy"):
        assert (tmp_path / "torch" / name).exists(), name
    np.testing.assert_array_equal(np.load(tmp_path / "torch" / "all_masks.npy"),
                                  np.load(tmp_path / "jax" / "all_masks.npy"))
    np.testing.assert_allclose(np.load(tmp_path / "torch" / "all_input_encode_cheap.npy"),
                               np.load(tmp_path / "jax" / "all_input_encode_cheap.npy"),
                               rtol=0, atol=1e-5)

    # the restored anneal state gives the reference's pnm * factor^min(step, num_iter)
    srv = Server(Config.load(str(run / "config.json")).replace(save_path=None), sinos, theta,
                 torch.device("cpu"))
    srv.restore(str(run))
    assert srv.step == 37
    want = np.float32(cfg.pnm_start) * (
        srv.pnm_anneal_factor ** jnp.minimum(jnp.int32(37), cfg.num_iter).astype(jnp.float32))
    np.testing.assert_allclose(float(srv.annealed_pnm()), float(want), rtol=1e-6)


def test_cli_infer_on_cpu(tmp_path, capsys):
    sinos, theta = _data()
    run = tmp_path / "run"
    _trained_run(run, sinos, theta)
    data = tmp_path / "data"
    data.mkdir()
    np.save(data / "x_train_sinograms.npy", sinos)
    np.save(data / "dataset_parameters.npy", np.array([theta, P], dtype=object))
    rc = cli.main(["infer", "--run_path", str(run), "--input_path", str(data), "--output",
                   str(tmp_path / "out"), "--cheap_init", "--passes", "1", "--device", "cpu"])
    assert rc == 0
    assert "reconstructed 10 examples" in capsys.readouterr().out
    mean = np.load(tmp_path / "out" / "reconstruction_mean.npy")
    assert mean.shape == (N, 31, 31, 1) and np.isfinite(mean).all()


def test_default_draws_come_from_the_steps_generator(tmp_path):
    """Without a sampler, every eval step draws inside itself from one
    generator seeded ``seed + 7`` (a Normal run, as a Beta run): the same
    results, bitwise, as that generator handed over as the draw source."""
    sinos, theta = _data()
    run = tmp_path / "run"
    _trained_run(run, sinos, theta)
    kw = dict(sinograms=sinos, theta=theta, num_passes=PASSES, overrides=OVERRIDES, seed=3,
              device="cpu")
    out = amortized_infer(str(run), None, **kw)
    gen = torch.Generator().manual_seed(3 + 7)
    want = amortized_infer(str(run), None, **kw,
                           sampler=lambda *_: GeneratorDraws(gen, torch.device("cpu")))
    for k in ("mean", "std", "sample", "loss"):
        np.testing.assert_array_equal(out[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    sinos, theta = _data()
    run = tmp_path_factory.mktemp("finish") / "run"
    _trained_run(run, sinos, theta)
    return run, sinos, theta


@pytest.mark.parametrize("num_passes", [1, 2, 8])
def test_outputs_are_the_float64_finish_of_the_passes(run_dir, monkeypatch, num_passes):
    """The moments, the float64 finish and the losses made on the device
    equal, bitwise, the host finish of each pass's maps (N % BATCH != 0: a
    tail batch); the outputs keep their dtypes and shapes."""
    run, sinos, theta = run_dir
    passes = finish.record_passes(monkeypatch)
    out = amortized_infer(str(run), None, sinograms=sinos, theta=theta, num_passes=num_passes,
                          overrides=OVERRIDES, seed=3, device="cpu")
    assert N % BATCH and len(passes) == -(-N // BATCH) * num_passes
    finish.assert_bitwise(out, finish.host_finish(passes, N, BATCH, num_passes))
    assert out["mean"].shape == (N, 31, 31, 1) and out["loss"].shape == (-(-N // BATCH),)


def test_entry_points_refuse_cuda_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        amortized_infer(str(tmp_path), None)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["infer", "--run_path", str(tmp_path), "--output", str(tmp_path / "o")])


BANNED = {"jax", "jaxlib", "flax", "optax", "msgpack", "yaml", "ct_pvae_tpu"}
# chains over ranks, the sweep, the native binding, the API and the samplers' bench
NEW_MODULES = ("parallel/chains.py", "hpo.py", "native.py", "api.py", "eval/bench_samplers.py", "cli.py")


def _port_sources():
    pkg = os.path.join(REPO, "ct_pvae_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_nothing_of_jax():
    """No port module or chip_smoke.py imports jax, flax, optax, msgpack, yaml
    or the JAX package, the training slice's modules and the gather route,
    kernel E and its probe, the MCMC slice's samplers and runs, the eval
    stage's modules, the sharded trainer's (parallel/, vi/shard.py) and the
    rest of the CLI's (chains, hpo, native, api, bench_samplers) included."""
    offenders, scanned = [], set()
    for path in _port_sources():
        scanned.add(os.path.relpath(path, REPO))
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in BANNED:
                    offenders.append(f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}")
    assert not offenders, offenders
    for module in ("vi/train.py", "ops/sirt.py", "ops/tv.py", "utils/batching.py",
                   "utils/metrics.py", "utils/flax_msgpack.py", "ops/joseph_radon.py",
                   "ops/radon.py", "ops/conv_fused.py", "scripts/probe_conv_fused.py",
                   "utils/yaml_subset.py", "ops/gridrec.py", "data/foam.py", "data/toy.py",
                   "data/sinogram.py", "vi/augment.py", "mcmc/hmc.py", "mcmc/nuts.py", "mcmc/smc.py",
                   "mcmc/draws.py", "mcmc/diagnostics.py", "mcmc/toy_model.py", "mcmc/image_model.py",
                   "prob/bijectors.py", "eval/mcmc_run.py", "eval/metrics.py", "eval/merit.py",
                   "eval/visualize.py", "eval/pixel_dist.py", "eval/fidelity.py",
                   "eval/dataset_viz.py", "eval/boxplot.py", "eval/plots.py", "data/real.py",
                   "parallel/__init__.py", "parallel/distributed.py", "parallel/mesh.py",
                   "vi/shard.py") + NEW_MODULES:
        assert os.path.join("ct_pvae_tpu_torch", module) in scanned, module
    # the last slice's modules import neither matplotlib nor h5py when imported
    for module in NEW_MODULES:
        path = os.path.join(REPO, "ct_pvae_tpu_torch", module)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in tree.body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
            assert not any(n.split(".")[0] in ("matplotlib", "h5py") for n in names), (module, names)
    assert num_proj_pixels(128, 128) == 184  # the foam geometry the port serves
