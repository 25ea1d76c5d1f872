"""The toy recipe (``configs/toy.yaml``: a 2-pixel detector, ``no_pad``,
``toy_masks``, kernel 2, stride 1, 5 intermediate layers, 10 ELBO samples,
gridrec init) on the port's gather route against the JAX Trainer, which
takes its XLA gather projector there (n_det < 64, train.py:254-256); and
serving on the real sirt/tv init stack against the JAX package's TPU route.

Both trainers see the JAX run's masks, measurements and init stack (its
cache files, read through ``reuse_cache``), its initial params (``ckpt-0``),
the same index streams and the JAX run's draws.
"""

import importlib
import os
import shutil

import jax
import numpy as np
import pytest

from _torch_parity import JaxReplaySampler, JaxTrainSampler
from ct_pvae_tpu.config import Config as JaxConfig
from ct_pvae_tpu.vi.infer import amortized_infer as jax_amortized_infer
from ct_pvae_tpu.vi.train import Trainer as JaxTrainer
from ct_pvae_tpu_torch import cli
from ct_pvae_tpu_torch.config import Config
from ct_pvae_tpu_torch.ops import joseph_radon, radon
from ct_pvae_tpu_torch.vi.infer import amortized_infer
from ct_pvae_tpu_torch.vi.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_DATA = os.path.join(REPO, "dataset_toy_discrete2")
N, STEPS = 8, 5
LR = Config().learning_rate
CACHES = ("all_masks.npy", "all_proj_samples.npy", "all_input_encode.npy")


def _toy_kw(**over):
    """configs/toy.yaml's recipe, cut to the first N sinograms and STEPS steps."""
    kw = Config.load(os.path.join(REPO, "configs", "toy.yaml")).to_dict()
    return {**kw, "input_path": None, "truncate_dataset": N, "num_iter": STEPS,
            "metrics_every": 2, **over}


def _toy_data():
    sinos = np.load(os.path.join(TOY_DATA, "x_train_sinograms.npy"))[:N]
    theta, _ = np.load(os.path.join(TOY_DATA, "dataset_parameters.npy"), allow_pickle=True)
    return sinos, np.asarray(theta, np.float32)


def _flat_params(tree):
    if isinstance(tree, dict):
        return np.concatenate([_flat_params(tree[k]) for k in sorted(tree)])
    return np.asarray(tree).ravel()


@pytest.fixture(scope="module")
def jax_toy_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    sinos, theta = _toy_data()
    tr = JaxTrainer(JaxConfig(**_toy_kw(save_path=str(root / "jax"))), sinograms=sinos,
                    theta=theta)
    tr.checkpoint()
    params0 = jax.tree_util.tree_map(np.asarray, tr.state.params)
    with pytest.MonkeyPatch.context() as mp:  # the reference's loss plots cost seconds here
        mp.setattr(tr.metrics, "save_plots", lambda: None)
        tr.train()
    return dict(root=root, sinos=sinos, theta=theta, params0=params0,
                losses=np.asarray(tr.metrics.history["loss"]),
                params=jax.tree_util.tree_map(np.asarray, tr.state.params))


def test_toy_recipe_matches_jax_on_the_gather_route(jax_toy_run):
    """5 steps: the loss trajectory to float32, the params within 3 lr (Adam's
    first steps move an element by about lr whatever its gradient's size), and
    no Joseph launch on the way."""
    d = jax_toy_run["root"] / "port"
    (d / "training_checkpoints").mkdir(parents=True)
    for f in CACHES:
        shutil.copy(jax_toy_run["root"] / "jax" / f, d / f)
    shutil.copy(jax_toy_run["root"] / "jax" / "training_checkpoints" / "ckpt-0.msgpack",
                d / "training_checkpoints")
    cfg = Config(**_toy_kw(save_path=str(d), reuse_cache=True, restore=True))
    tr = Trainer(cfg, jax_toy_run["sinos"], jax_toy_run["theta"], "cpu",
                 JaxTrainSampler(cfg.seed))
    assert not tr.joseph and tr.x_size == 2
    calls, launches = radon.CALLS["radon"], dict(joseph_radon.LAUNCHES)
    tr.train()
    assert radon.CALLS["radon"] == calls + STEPS
    assert joseph_radon.LAUNCHES == launches
    np.testing.assert_allclose(np.load(d / "train_loss_vec.npy"), jax_toy_run["losses"], rtol=1e-4)
    state = tr.state_tree()
    got, want = _flat_params(state["params"]), _flat_params(jax_toy_run["params"])
    assert np.abs(got - want).max() <= 3 * LR
    moved = np.abs(want - _flat_params(jax_toy_run["params0"]))
    assert np.median(moved) > 100 * 1e-6  # the steps moved the params


def test_cli_trains_the_toy_yaml_recipe_on_cpu(tmp_path, capsys):
    """``cli train --config configs/toy.yaml`` on dataset_toy_discrete2 (its 64
    sinograms, 2 steps) runs on the gather route, and ``cli infer`` serves the
    run the same way."""
    calls, launches = radon.CALLS["radon"], dict(joseph_radon.LAUNCHES)
    rc = cli.main(["train", "--config", os.path.join(REPO, "configs", "toy.yaml"),
                   "--input_path", TOY_DATA, "--save_path", str(tmp_path / "run"), "-i", "2",
                   "--device", "cpu"])
    assert rc == 0
    assert "Average loss final : " in capsys.readouterr().out
    assert radon.CALLS["radon"] == calls + 2 + 64 // 4  # 2 steps, 16 final-evaluation batches
    assert joseph_radon.LAUNCHES == launches
    cfg = Config.load(str(tmp_path / "run" / "config.json"))
    assert cfg.toy_masks and cfg.no_pad and cfg.num_samples == 10 and cfg.num_iter == 2
    assert np.isfinite(np.load(tmp_path / "run" / "loss_final.npy")).all()

    calls = radon.CALLS["radon"]
    rc = cli.main(["infer", "--run_path", str(tmp_path / "run"), "--input_path", TOY_DATA,
                   "--output", str(tmp_path / "out"), "--passes", "1", "--device", "cpu"])
    assert rc == 0 and "reconstructed 64 examples" in capsys.readouterr().out
    assert radon.CALLS["radon"] == calls + 64 // 4 and joseph_radon.LAUNCHES == launches
    mean = np.load(tmp_path / "out" / "reconstruction_mean.npy")
    assert mean.shape == (64, 2, 2, 1) and np.isfinite(mean).all()


def test_serving_on_the_real_init_stack_matches_jax_tpu_route(tmp_path, monkeypatch):
    """``amortized_infer`` without ``cheap_init``: the paper's sirt/tv/fbp/
    gridrec stack (sirt and tv on kernels C and D's plain versions) against
    the JAX package's accelerator route (radon_pallas / backproject_pallas in
    interpret mode).  A 48-pixel detector keeps both ELBOs on the gather
    projector, so the loss is compared too."""
    rng = np.random.default_rng(0)
    n, a, p = 4, 12, 48
    theta = np.sort(rng.uniform(0, np.pi, a)).astype(np.float32)
    sinos = rng.uniform(0, 5, (n, a, p)).astype(np.float32)
    run = tmp_path / "run"
    cfg = JaxConfig(
        save_path=str(run), train=True, truncate_dataset=n, batch_size=2, num_sparse_angles=4,
        angles_per_iter=4, random_angles=True, num_samples=2, poisson_noise_multiplier=1e4,
        pnm_start=1e3, num_iter=100, algorithms=["sirt", "tv", "fbp", "gridrec"], num_blocks=2,
        num_feature_maps=4, intermediate_layers=1, kernel_size=4, intermediate_kernel=4,
        stride_encode=2, use_normal=True, real_data=True,
    )
    pr = importlib.import_module("ct_pvae_tpu.ops.pallas_radon")
    fwd, adj = pr.radon_pallas, pr.backproject_pallas
    monkeypatch.setattr(pr, "radon_pallas", lambda img, th, n_: fwd(img, th, n_, True))
    monkeypatch.setattr(pr, "backproject_pallas", lambda s, th, h, w: adj(s, th, h, w, True))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    JaxTrainer(cfg, sinograms=sinos, theta=theta).checkpoint()
    overrides = {"real_data": True}
    ref = jax_amortized_infer(str(run), str(tmp_path / "jax"), sinograms=sinos, theta=theta,
                              num_passes=2, overrides=overrides, seed=3)
    out = amortized_infer(str(run), str(tmp_path / "torch"), sinograms=sinos, theta=theta,
                          num_passes=2, overrides=overrides, seed=3, device="cpu",
                          sampler=JaxReplaySampler(3, n // 2, 2))
    # the init stack: float32 through 30 / 60 iterations of the pair in two
    # frameworks, as tests/test_torch_init.py holds it
    stack_o = np.load(tmp_path / "torch" / "all_input_encode.npy")
    stack_r = np.load(tmp_path / "jax" / "all_input_encode.npy")
    assert stack_o.shape == stack_r.shape == (n, 31, 31, 5)
    for c in range(5):
        np.testing.assert_allclose(stack_o[..., c], stack_r[..., c], rtol=0,
                                   atol=5e-5 * np.abs(stack_r[..., c]).max())
    # the outputs as tests/test_torch_infer.py holds them
    np.testing.assert_allclose(out["mean"], ref["mean"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["sample"], ref["sample"], rtol=0, atol=1e-4)
    var_o, var_r = out["std"].astype(np.float64) ** 2, ref["std"].astype(np.float64) ** 2
    np.testing.assert_allclose(var_o, var_r, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-4)
