"""The port's training slice (vi/train.py, cli train) against the JAX
package's ``Trainer`` on the CPU: optimiser, step-0 loss and gradients, a
3-step run, checkpoints both ways, resume, and the CLI.

Both trainers see the same masks, Poisson measurements and init stack (the
JAX run's cache files, read through ``reuse_cache``), the same initial
params (the JAX run's ``ckpt-0``), the same index streams and the JAX run's
draws.  The JAX Trainer takes its Pallas route (kernels A/B in interpret
mode) only with ``n_det >= 64`` and a mesh, so it gets a 64-pixel detector
and a one-device mesh; the port's trainer gets the counterpart,
``kernel_route=True`` (its Joseph kernels' plain versions on the CPU).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from _torch_parity import JaxTrainSampler
from ct_pvae_tpu.config import Config as JaxConfig
from ct_pvae_tpu.ops.pallas_radon import angle_table_fused, radon_pallas_fused
from ct_pvae_tpu.utils.batching import IndexStream as JaxIndexStream
from ct_pvae_tpu.vi.loss import elbo_loss
from ct_pvae_tpu.vi.train import Trainer as JaxTrainer
from ct_pvae_tpu.vi.train import nan_zero_and_clip
from ct_pvae_tpu_torch import cli
from ct_pvae_tpu_torch.config import Config
from ct_pvae_tpu_torch.models.pvae import branch_halves, build_models, init_params, params_to_flax
from ct_pvae_tpu_torch.utils.batching import IndexStream
from ct_pvae_tpu_torch.vi.train import (
    ADAM_B1, ADAM_B2, Trainer, adam_, adam_bias_corrections, nan_zero_and_clip_,
)

N, A, P, BATCH, STEPS = 8, 24, 64, 4, 3
CPU = torch.device("cpu")
KW = dict(
    truncate_dataset=N, batch_size=BATCH, num_sparse_angles=6, angles_per_iter=5,
    random_angles=True, num_samples=2, poisson_noise_multiplier=1e4, pnm_start=1e3,
    num_iter=STEPS, algorithms=["fbp", "gridrec"], num_blocks=2,
    num_feature_maps=4, num_feature_maps_multiplier=1.1, intermediate_layers=1,
    kernel_size=4, intermediate_kernel=4, stride_encode=2, use_normal=True, train=True,
    metrics_every=2, save_interval=100, seed=5,
)
LR = Config().learning_rate  # KW keeps the default, 1e-4
CACHES = ("all_masks.npy", "all_proj_samples.npy", "all_input_encode.npy")


def _data():
    rng = np.random.default_rng(0)
    theta = np.sort(rng.uniform(0, np.pi, A)).astype(np.float32)
    return rng.uniform(0, 5, (N, A, P)).astype(np.float32), theta


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run: step-0 loss and grads, then 3 steps and the final evaluation."""
    root = tmp_path_factory.mktemp("train")
    sinos, theta = _data()
    cfg = JaxConfig(save_path=str(root / "jax"), **KW)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "angle"))
    tr = JaxTrainer(cfg, sinograms=sinos, theta=theta, mesh=mesh)
    tr.checkpoint()  # ckpt-0: the initial params for the port
    params0 = _tree_np(tr.state.params)

    # step 0 by hand, as _build_step(training=True) computes it
    bidx = IndexStream(N, BATCH, cfg.seed + 1).next()
    aidx = IndexStream(A, KW["angles_per_iter"], cfg.seed + 2).next()
    key0 = jax.random.fold_in(tr.loop_key, 0)
    table = jnp.asarray(angle_table_fused(tr.theta, tr.x_size, tr.x_size, P))
    batch = {k: jnp.take(v, jnp.asarray(bidx), axis=0) for k, v in tr.data.items()}
    (loss0, _), grads0 = jax.jit(jax.value_and_grad(
        lambda p: elbo_loss(
            p, batch, key0, encoder=tr.encoder, decoder=tr.decoder, theta=jnp.asarray(tr.theta),
            angles_i=jnp.asarray(aidx), kl_anneal=jnp.float32(1.0), kl_multiplier=1.0,
            pnm=jnp.float32(cfg.pnm_start), num_samples=2, use_normal=True, deterministic=False,
            num_blocks=2, pad=True, n_det=P, training=True,
            project_fn=lambda r, ai: radon_pallas_fused(r, table[ai], P, True),
        ),
        has_aux=True,
    ))(tr.state.params)

    with pytest.MonkeyPatch.context() as mp:  # the reference's loss plots cost ~10 s here
        mp.setattr(tr.metrics, "save_plots", lambda: None)
        tr.train()
    loss_final = tr.final_evaluation()
    return dict(
        root=root, sinos=sinos, theta=theta, cfg=cfg, bidx=bidx, aidx=aidx,
        params0=params0, loss0=float(loss0), grads0=_tree_np(grads0),
        losses=np.asarray(tr.metrics.history["loss"]), params=_tree_np(tr.state.params),
        adam=_tree_np(tr.state.opt_state[1][0]), loss_final=loss_final,
        recon_mean=np.load(root / "jax" / "reconstruction_mean.npy"),
    )


def _port_run_dir(jax_run, name):
    """A port run dir holding the JAX run's caches and its ckpt-0."""
    d = jax_run["root"] / name
    (d / "training_checkpoints").mkdir(parents=True)
    for f in CACHES:
        shutil.copy(jax_run["root"] / "jax" / f, d / f)
    shutil.copy(jax_run["root"] / "jax" / "training_checkpoints" / "ckpt-0.msgpack",
                d / "training_checkpoints" / "ckpt-0.msgpack")
    return d


def _port_trainer(jax_run, save_path, **over):
    cfg = Config(save_path=str(save_path), reuse_cache=True, **{**KW, **over})
    return Trainer(cfg, jax_run["sinos"], jax_run["theta"], CPU, JaxTrainSampler(KW["seed"]),
                   kernel_route=True)


def _flat(tree):
    """The leaves of a nested dict of arrays, in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat(tree[k])]
    return [np.asarray(tree)]


def _assert_tree_close(got, want, rtol, atol, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_tree_close(got[k], want[k], rtol, atol, f"{where}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                                   err_msg=where)


@pytest.mark.parametrize("shuffle", [True, False])
def test_index_stream_is_the_jax_sequence(shuffle):
    """The port's copy of IndexStream draws the JAX package's batches, across
    epochs and after a skip (the resume replay)."""
    ours, ref = IndexStream(10, 4, 3, shuffle), JaxIndexStream(10, 4, 3, shuffle)
    for _ in range(7):
        np.testing.assert_array_equal(ours.next(), ref.next())
    ours.skip(5)
    ref.skip(5)
    for _ in range(4):
        out = ours.next()
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out, ref.next())


def test_optimizer_matches_optax():
    """nan_zero_and_clip + Adam (eps 1e-7) on a small tree with a NaN and a
    leaf above the clip norm, 4 updates; and optax's Adam against torch's
    ``torch.optim.Adam`` on the same gradients (same denominator, sqrt(v_hat) + eps)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * sc).astype(np.float32)
              for (k, s), sc in zip(shapes.items(), (1.0, 300.0, 1e-7))} for _ in range(4)]
    grads[0]["a"][0, 0] = np.nan
    lr, eps, norm = 1e-2, 1e-7, 100.0
    tx = optax.chain(nan_zero_and_clip(norm), optax.adam(lr, eps=eps))
    p_j = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(p_j)
    ours = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in ours.items()}
    nu = {k: torch.zeros_like(v) for k, v in ours.items()}
    ref_t = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = torch.optim.Adam(list(ref_t.values()), lr=lr, betas=(ADAM_B1, ADAM_B2), eps=eps)
    for count, g in enumerate(grads, start=1):
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for k in ours:
            gt = torch.from_numpy(g[k].copy())
            nan_zero_and_clip_(gt, (gt,), norm)
            adam_(ours[k], gt, mu[k], nu[k], adam_bias_corrections(count), lr, eps)
            ref_t[k].grad = gt
        opt.step()
    for k in ours:
        # the port follows optax's op order in float32: within 1 ulp (the clip's
        # norm sums in another order)
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(p_j[k]), rtol=1e-6, atol=1e-7)
        # torch's Adam has the same denominator, sqrt(v_hat) + eps; its lerp
        # and float64 bias corrections round differently: within a few ulps
        np.testing.assert_allclose(ref_t[k].detach().numpy(), np.asarray(p_j[k]), rtol=1e-5, atol=1e-7)


def test_clip_is_per_flax_leaf():
    """The clip takes each maxout branch (flax leaf) of a port tensor apart:
    gradients whose halves straddle the clip norm, on an encoder and a
    decoder (transpose convs split on dim 1), against optax's transform on
    the flax tree."""
    cfg = Config(**{k: v for k, v in KW.items() if k != "train"})
    enc, dec, _ = build_models(16, 16, 3, cfg)
    rng = np.random.default_rng(1)
    for model in (enc, dec):
        grads = {k: torch.from_numpy((rng.normal(size=tuple(p.shape)) * 50).astype(np.float32))
                 for k, p in model.named_parameters()}
        for k, g in grads.items():  # one branch far above the norm, the other below
            branch_halves(model.blocks[int(k.split(".")[1])], k.split(".")[2], g)[0].mul_(0.01)
        ref = params_to_flax(model, grads)
        ref, _ = nan_zero_and_clip(100.0).update(jax.tree_util.tree_map(jnp.asarray, ref), None)
        for k, g in grads.items():
            _, i, kind = k.split(".")
            nan_zero_and_clip_(g, branch_halves(model.blocks[int(i)], kind, g), 100.0)
        _assert_tree_close(params_to_flax(model, grads), _tree_np(ref), rtol=1e-6, atol=0)


def test_step0_loss_and_grads_match_jax(jax_run, tmp_path):
    """Loss and every parameter's gradient of the first train step, at the
    same params, batch, angle subset and draws (kernel B is the backward)."""
    tr = _port_trainer(jax_run, _port_run_dir(jax_run, "step0"), restore=True)
    assert tr.step == 0 and tr.adam_count == 0
    _assert_tree_close({"encoder": params_to_flax(tr.encoder), "decoder": params_to_flax(tr.decoder)},
                       jax_run["params0"], 0, 0)
    shapes, out_shape = tr.draw_shapes(BATCH)
    draws = tr.sampler("train", 0, shapes, out_shape, 2)
    loss, _, grads = tr.loss_and_grads(torch.as_tensor(jax_run["bidx"]),
                                       torch.as_tensor(jax_run["aidx"]), draws)
    # the loss is a float32 sum of ~10^4 terms that largely cancel: 6.6e-6 measured
    np.testing.assert_allclose(loss.item(), jax_run["loss0"], rtol=1e-4)
    named = iter(grads)
    got = {name: params_to_flax(m, {k: next(named) for k, _ in m.named_parameters()})
           for name, m in tr.models.items()}
    # float32 sums in another order through ~20 conv layers and the projector:
    # each gradient to 1e-4 of its leaf's largest entry
    for name in got:
        for blk, leaves in jax_run["grads0"][name].items():
            for br, leaf in leaves.items():
                for k, want in leaf.items():
                    scale = np.abs(want).max()
                    np.testing.assert_allclose(got[name][blk][br][k], want, rtol=0,
                                               atol=1e-4 * scale, err_msg=f"{name}/{blk}/{br}/{k}")


def test_three_step_trainer_matches_jax(jax_run):
    """3 steps and the final evaluation: the loss trajectory, the params
    (Adam's first steps move every element by about lr, the sign set by the
    gradient, so tiny gradient differences can flip an element: a few x lr),
    the Adam moments and the posterior-mean reconstruction."""
    d = _port_run_dir(jax_run, "three")
    tr = _port_trainer(jax_run, d, restore=True)
    tr.train()
    loss_final = tr.final_evaluation()
    np.testing.assert_allclose(np.load(d / "train_loss_vec.npy"), jax_run["losses"], rtol=1e-4)
    np.testing.assert_array_equal(np.load(d / "iter_vec.npy"), np.arange(1, STEPS + 1))
    state = tr.state_tree()
    assert int(state["step"]) == STEPS and int(state["opt_state"]["1"]["0"]["count"]) == STEPS
    # Adam's first steps move an element by about lr whatever its gradient's
    # size, so an element whose gradient is near eps may flip sign between
    # two float32 sums: all within 3 lr, and 99.9% within 1e-6 (the port
    # measured 3e-8 at most here, against a median move of 2e-4)
    got = np.concatenate([v.ravel() for v in _flat(state["params"])])
    want = np.concatenate([v.ravel() for v in _flat(jax_run["params"])])
    start = np.concatenate([v.ravel() for v in _flat(jax_run["params0"])])
    assert np.abs(got - want).max() <= 3 * LR
    assert np.mean(np.abs(got - want) <= 1e-6) >= 0.999
    assert np.median(np.abs(want - start)) > 100 * 1e-6  # the steps moved the params
    np.testing.assert_allclose(loss_final, jax_run["loss_final"], rtol=1e-4)
    np.testing.assert_allclose(np.load(d / "reconstruction_mean.npy"), jax_run["recon_mean"],
                               rtol=0, atol=1e-5)
    for name in ("setup_time.npy", "training_time.npy", "loss_final.npy",
                 "reconstruction_final.npy", "metrics.jsonl", "train_loss_kl.npy"):
        assert (d / name).exists(), name
    assert (d / "training_checkpoints" / f"ckpt-{STEPS}.msgpack").exists()


def test_checkpoint_restores_both_ways(jax_run, tmp_path):
    """A port checkpoint restores in the JAX Trainer (step, params, Adam
    moments, anneal state equal) and the JAX run's restores in the port."""
    tr = _port_trainer(jax_run, tmp_path / "port")
    shapes, out_shape = tr.draw_shapes(BATCH)
    tr.train_step(torch.as_tensor(jax_run["bidx"]), torch.as_tensor(jax_run["aidx"]),
                  tr.sampler("train", 0, shapes, out_shape, 2))
    tr.checkpoint()
    want = tr.state_tree()

    jcfg = JaxConfig(save_path=str(tmp_path / "port"), reuse_cache=True, **KW)
    jtr = JaxTrainer(jcfg, sinograms=jax_run["sinos"], theta=jax_run["theta"])
    jtr.restore(use_latest=True)
    assert int(jtr.state.step) == 1
    assert float(jtr.state.kl_anneal) == float(want["kl_anneal"])
    assert float(jtr.state.pnm) == float(want["pnm"])
    _assert_tree_close(_tree_np(jtr.state.params), want["params"], 0, 0)
    adam = _tree_np(jtr.state.opt_state[1][0])
    assert int(adam.count) == 1
    _assert_tree_close(adam.mu, want["opt_state"]["1"]["0"]["mu"], 0, 0)
    _assert_tree_close(adam.nu, want["opt_state"]["1"]["0"]["nu"], 0, 0)

    # the JAX run's final checkpoint, read by the port
    d = _port_run_dir(jax_run, "back")
    shutil.copy(jax_run["root"] / "jax" / "training_checkpoints" / f"ckpt-{STEPS}.msgpack",
                d / "training_checkpoints")
    back = _port_trainer(jax_run, d, restore=True, use_latest_ckpt=True)
    st = back.state_tree()
    assert int(st["step"]) == STEPS
    _assert_tree_close(st["params"], jax_run["params"], 0, 0)
    _assert_tree_close(st["opt_state"]["1"]["0"]["mu"], jax_run["adam"].mu, 0, 0)
    _assert_tree_close(st["opt_state"]["1"]["0"]["nu"], jax_run["adam"].nu, 0, 0)


def test_r4_checkpoint_restores_with_adam_state(tmp_path):
    """The paper run's ckpt-100000 (full width) restores into the port's
    Trainer, Adam moments included, and writes back bitwise the same leaves."""
    from ct_pvae_tpu_torch.utils.flax_msgpack import load_checkpoint

    r4 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "results", "foam_paper_run_r4")
    cfg = Config.load(os.path.join(r4, "config.json")).replace(
        save_path=str(tmp_path), input_path=None, truncate_dataset=10, restore=True,
        use_latest_ckpt=True)
    (tmp_path / "training_checkpoints").mkdir()
    os.symlink(os.path.join(r4, "ckpt-100000.msgpack"),
               tmp_path / "training_checkpoints" / "ckpt-100000.msgpack")
    theta = np.linspace(0, np.pi, 180, endpoint=False).astype(np.float32)
    sinos = np.zeros((10, 180, 184), np.float32)
    np.save(tmp_path / "all_input_encode.npy", np.zeros((10, 128, 128, 5), np.float32))  # skip the init
    tr = Trainer(cfg, sinos, theta, CPU)
    ckpt = load_checkpoint(os.path.join(r4, "ckpt-100000.msgpack"))
    st = tr.state_tree()
    assert tr.step == 100000 and tr.adam_count == 100000
    _assert_tree_close(st["params"], ckpt["params"], 0, 0)
    _assert_tree_close(st["opt_state"], ckpt["opt_state"], 0, 0)


class _Killed(Exception):
    pass


def test_kill_and_resume_matches_uninterrupted(tmp_path, monkeypatch):
    """Port only: a 6-step run killed after its 3rd step (checkpoint every
    step), relaunched with --restore --ulc --resume_total, ends where 6
    uninterrupted steps end: same params, Adam state and losses."""
    sinos, theta = _data()
    cfg = Config(**{**KW, "algorithms": ["fbp", "gridrec"], "save_interval": 1, "num_iter": 6})
    full = Trainer(cfg.replace(save_path=str(tmp_path / "full")), sinos, theta, CPU)
    full.train()

    victim = Trainer(cfg.replace(save_path=str(tmp_path / "cut")), sinos, theta, CPU)
    step = victim.train_step

    def dies_after_3(*args):
        if victim.step == 3:
            raise _Killed
        return step(*args)

    monkeypatch.setattr(victim, "train_step", dies_after_3)
    with pytest.raises(_Killed):
        victim.train()
    resumed = Trainer(cfg.replace(save_path=str(tmp_path / "cut"), restore=True,
                                  use_latest_ckpt=True, resume_total=True), sinos, theta, CPU)
    assert resumed.step == 3
    resumed.train()
    a, b = full.state_tree(), resumed.state_tree()
    assert int(b["step"]) == 6
    _assert_tree_close(b["params"], a["params"], 0, 0)
    _assert_tree_close(b["opt_state"], a["opt_state"], 0, 0)
    np.testing.assert_array_equal(np.load(tmp_path / "cut" / "train_loss_vec.npy"),
                                  np.load(tmp_path / "full" / "train_loss_vec.npy")[3:])


def test_init_params_follow_flax_glorot():
    """Glorot-uniform over flax's HWIO fans, per maxout branch; zero biases."""
    cfg = Config(**{k: v for k, v in KW.items() if k not in ("train",)})
    enc, dec, _ = build_models(43, 43, 5, cfg)
    gen = torch.Generator().manual_seed(0)
    for model in (enc, dec):
        init_params(model, gen)
        for blk, leaves in params_to_flax(model).items():
            for leaf in leaves.values():
                kh, kw, i, o = leaf["kernel"].shape
                limit = np.sqrt(6.0 / (kh * kw * (i + o)))
                assert np.abs(leaf["kernel"]).max() <= limit
                assert np.abs(leaf["kernel"]).max() > 0.8 * limit
                assert not leaf["bias"].any()


def test_cli_train_on_cpu(tmp_path, capsys):
    sinos, theta = _data()
    data = tmp_path / "data"
    data.mkdir()
    np.save(data / "x_train_sinograms.npy", sinos)
    np.save(data / "dataset_parameters.npy", np.array([theta, P], dtype=object))
    rc = cli.main(["train", "--input_path", str(data), "--save_path", str(tmp_path / "run"),
                   "--train", "-b", "4", "--td", "8", "-i", "2", "--nsa", "6", "--api", "5",
                   "--random", "--algorithms", "fbp", "gridrec", "--nb", "2", "--nfm", "4",
                   "--il", "1", "--normal", "--device", "cpu"])
    assert rc == 0
    assert "Average loss final : " in capsys.readouterr().out
    cfg = Config.load(str(tmp_path / "run" / "config.json"))
    assert cfg.num_iter == 2 and cfg.algorithms == ["fbp", "gridrec"]
    # a YAML recipe loads, and typed flags override it
    (tmp_path / "c.yaml").write_text("# recipe\nbatch_size: 10\npnm_start: 1.0e3\nalgorithms: [fbp]\n")
    cfg, device = cli._parse_train_cfg(["--config", str(tmp_path / "c.yaml"), "-b", "3"], "train")
    assert (cfg.batch_size, cfg.pnm_start, cfg.algorithms, device) == (3, 1000.0, ["fbp"], "cuda")
    with pytest.raises(NotImplementedError, match="multihost"):
        cli.main(["train", "--input_path", str(data), "--multihost", "--device", "cpu"])
