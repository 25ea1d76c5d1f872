"""The training options of the port (Beta latents and output, deterministic
mode, dropout, InstanceNorm, ``conv_impl``, bfloat16, ``train_pnm``,
``steps_per_call`` chunks and ``profile_steps``) against the JAX package on
the CPU, at toy size: a 24-pixel detector (both sides take the gather
projector), 14^2 recons, 2 blocks, a few angles.

Both sides get the same numpy inputs and the same params; where the JAX
package draws random numbers the port is handed the same numbers (the
latent normals, the output uniforms, the log-gamma variates of
``jax.random.beta``), recomputed from the JAX key tree.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import JaxTrainSampler, jax_draws
from ct_pvae_tpu.config import Config as JaxConfig
from ct_pvae_tpu.models.pvae import ConvBlock as JaxConvBlock
from ct_pvae_tpu.models.pvae import build_models as jax_build_models
from ct_pvae_tpu.prob import distributions as jd
from ct_pvae_tpu.vi.loss import elbo_loss as jax_elbo_loss
from ct_pvae_tpu.vi.train import Trainer as JaxTrainer
from ct_pvae_tpu_torch import cli
from ct_pvae_tpu_torch.config import Config
from ct_pvae_tpu_torch.models.pvae import ConvBlock, build_models, params_from_flax, params_to_flax
from ct_pvae_tpu_torch.prob import distributions as td
from ct_pvae_tpu_torch.vi.loss import Draws
from ct_pvae_tpu_torch.vi.train import Trainer

N, A, P, BATCH = 4, 12, 24, 2
X = 14  # floor(24 / sqrt(2) - 2)
CPU = torch.device("cpu")
KW = dict(
    truncate_dataset=N, batch_size=BATCH, num_sparse_angles=6, angles_per_iter=5,
    random_angles=True, num_samples=2, poisson_noise_multiplier=1e4, pnm_start=1e3,
    algorithms=["fbp"], num_blocks=2, num_feature_maps=4, intermediate_layers=1,
    kernel_size=4, intermediate_kernel=4, stride_encode=2, use_normal=True, train=True,
    metrics_every=3, seed=3,
)
LR = Config().learning_rate


def _data(seed=0):
    rng = np.random.default_rng(seed)
    theta = np.sort(rng.uniform(0, np.pi, A)).astype(np.float32)
    return rng.uniform(0, 5, (N, A, P)).astype(np.float32), theta


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat(tree[k])]
    return [np.asarray(tree)]


def _close_tree(got, want, rtol, atol, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _close_tree(got[k], want[k], rtol, atol, f"{where}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                                   err_msg=where)


# -- distributions ------------------------------------------------------------

def test_beta_log_prob_mean_kl_and_betaln_match_jax():
    """Beta log_prob, mean and the Beta-Beta KL, and betaln on both of its
    branches (below and above 8), against the JAX package in float32."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.05, 12.0, 500).astype(np.float32)
    b = rng.uniform(0.05, 30.0, 500).astype(np.float32)
    x = rng.uniform(1e-4, 1 - 1e-4, 500).astype(np.float32)
    a2 = rng.uniform(0.05, 5.0, 500).astype(np.float32)
    b2 = rng.uniform(0.05, 5.0, 500).astype(np.float32)
    t = lambda v: torch.from_numpy(v)
    p, q = td.Beta(t(a), t(b)), td.Beta(t(a2), t(b2))
    jp, jq = jd.Beta(jnp.asarray(a), jnp.asarray(b)), jd.Beta(jnp.asarray(a2), jnp.asarray(b2))
    # float32 lgamma / digamma differ between the two libraries by a few ulps
    # of terms up to ~70: 2e-5 absolute and relative
    np.testing.assert_allclose(p.log_prob(t(x)).numpy(), np.asarray(jp.log_prob(jnp.asarray(x))),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(p.mean().numpy(), np.asarray(jp.mean()), rtol=1e-6)
    np.testing.assert_allclose(td.kl_beta_beta(p, q).numpy(),
                               np.asarray(jd.kl_divergence(jp, jq)), rtol=2e-5, atol=2e-5)
    from jax.scipy.special import betaln

    np.testing.assert_allclose(td.betaln(t(a), t(b)).numpy(), np.asarray(betaln(a, b)),
                               rtol=2e-5, atol=2e-5)


def test_log_gamma_reparam_gradient_matches_jax():
    """The implicit gradient attached to given log-gamma variates equals
    ``jax.random.loggamma``'s, and the port's own draws have the gamma's mean."""
    alpha = np.array([0.02, 0.3, 0.9, 1.0, 2.5, 11.0], np.float32)
    key = jax.random.PRNGKey(4)
    lg, vjp = jax.vjp(lambda a: jax.random.loggamma(key, a), jnp.asarray(alpha))
    (want,) = vjp(jnp.ones_like(lg))
    a_t = torch.from_numpy(alpha).requires_grad_()
    td.reparam_log_gamma(a_t, torch.from_numpy(np.array(lg))).sum().backward()
    # float32 gamma-CDF derivatives: 1e-4 relative
    np.testing.assert_allclose(a_t.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    for a in (0.3, 2.5):
        draws = td.draw_log_gamma(torch.full((40000,), a), gen).exp()
        assert abs(float(draws.mean()) - a) < 4 * np.sqrt(a / 40000)  # Ga(a) has mean and variance a


# -- model options --------------------------------------------------------------

def _model_pair(**over):
    """JAX and port encoders/decoders of one config, the JAX params (scaled
    InstanceNorm leaves perturbed) carried into the port."""
    jcfg = JaxConfig(**{**KW, **over})
    cfg = Config(**{**KW, **over})
    jenc, jdec, shapes = jax_build_models(X, X, 2, jcfg)
    enc, dec, _ = build_models(X, X, 2, cfg)
    x = np.random.default_rng(1).normal(size=(3, X, X, 2)).astype(np.float32)
    pe = jax.jit(jenc.init)({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"]
    skips = jax.jit(jenc.apply)({"params": pe}, jnp.asarray(x))
    lat = skips if cfg.deterministic else [jnp.split(s, 2, axis=-1)[0] for s in skips]
    pd = jax.jit(jdec.init)({"params": jax.random.PRNGKey(1)}, lat)["params"]
    noise = lambda tree, seed: jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.3 * jax.random.normal(jax.random.PRNGKey(seed), v.shape)
        if "InstanceNorm" in jax.tree_util.keystr(path) else v, tree)
    pe, pd = noise(pe, 2), noise(pd, 3)
    enc.load_state_dict(params_from_flax(_np_tree(pe)))
    dec.load_state_dict(params_from_flax(_np_tree(pd)))
    return dict(jenc=jenc, jdec=jdec, pe=pe, pd=pd, enc=enc, dec=dec, x=x, lat=lat)


def _port_forward(m):
    skips = m["enc"](torch.from_numpy(m["x"]))
    lat = [torch.from_numpy(np.asarray(v)) for v in m["lat"]]
    return skips, m["dec"](lat)


def _jax_forward(m):
    skips = jax.jit(m["jenc"].apply)({"params": m["pe"]}, jnp.asarray(m["x"]))
    return skips, jax.jit(m["jdec"].apply)({"params": m["pd"]}, m["lat"])


def _assert_forward_close(got, want, rtol, atol):
    (gs, (gm, gv)), (ws, (wm, wv)) = got, want
    for g, w in zip(gs + [gm, gv], list(ws) + [wm, wv]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol, atol=atol)


def test_instance_norm_blocks_match_jax():
    """norm_type 'instance': the encoder and decoder with InstanceNorm after
    each maxout (not on the output head), params carried across with their
    ``InstanceNorm_0`` leaves and written back unchanged; float32 sums in
    another order: 1e-5."""
    m = _model_pair(norm_type="instance")
    _assert_forward_close(_port_forward(m), _jax_forward(m), 1e-5, 1e-5)
    _close_tree(params_to_flax(m["enc"]), _np_tree(m["pe"]), 0, 0)
    _close_tree(params_to_flax(m["dec"]), _np_tree(m["pd"]), 0, 0)


@pytest.mark.parametrize("impl", ["subpixel", "im2col"])
def test_conv_impls_match_direct_and_jax(impl):
    """conv_impl subpixel and im2col compute the same encoder skips, decoder
    maps and parameter gradients as direct, and the same maps as the JAX
    package's subpixel; float32 sums in another order: 1e-5."""
    m = _model_pair(conv_impl=impl)
    cfg = Config(**KW)
    enc0, dec0, _ = build_models(X, X, 2, cfg)
    enc0.load_state_dict(m["enc"].state_dict())
    dec0.load_state_dict(m["dec"].state_dict())
    got = _port_forward(m)
    base = _port_forward(dict(m, enc=enc0, dec=dec0))
    _assert_forward_close(got, [[s.detach().numpy() for s in base[0]],
                                [v.detach().numpy() for v in base[1]]], 1e-5, 1e-5)
    for model, ref in ((m["enc"], enc0), (m["dec"], dec0)):
        out = got[0] if model is m["enc"] else list(got[1])
        ref_out = base[0] if ref is enc0 else list(base[1])
        g = torch.autograd.grad(sum((o * o).sum() for o in out), list(model.parameters()))
        r = torch.autograd.grad(sum((o * o).sum() for o in ref_out), list(ref.parameters()))
        for a, b in zip(g, r):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4 * float(b.abs().max()))
    if impl == "subpixel":  # m's JAX models are the JAX package's subpixel ones
        _assert_forward_close(got, _jax_forward(m), 1e-5, 1e-5)


def test_dropout_block_matches_jax_on_the_kept_input():
    """A dropout ConvBlock with keep mask m equals JAX's block without dropout
    on x * m / (1 - p); without a mask source it is the plain block."""
    p = 0.3
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 9, 5)).astype(np.float32)
    keep = rng.uniform(size=x.shape) >= p
    jblk = JaxConvBlock(6, 4, 2)
    params = jblk.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"]
    want = jblk.apply({"params": params}, jnp.asarray(x * keep / np.float32(1 - p)))
    blk = ConvBlock(5, 6, 4, 2, dropout=p)
    blk.load_state_dict({k[len("blocks.0."):]: v
                         for k, v in params_from_flax({"ConvBlock_0": _np_tree(params)}).items()})
    nchw = lambda v: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
    keep_t = nchw(keep)
    got = blk(nchw(x), keep=lambda shape, prob: keep_t)
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    plain = jblk.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(blk(nchw(x)).detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(plain), rtol=1e-5, atol=1e-5)


def test_bfloat16_tracks_float32():
    """compute_dtype bfloat16 against the port's float32 path on the same
    params: skips and maps within 5e-2 of their scale (bfloat16 keeps 8
    significant bits, about 4e-3 a rounding, through 4 stored activations),
    the output head's maps in float32."""
    m = _model_pair()
    cfg = Config(**{**KW, "compute_dtype": "bfloat16"})
    enc, dec, _ = build_models(X, X, 2, cfg)
    enc.load_state_dict(m["enc"].state_dict())
    dec.load_state_dict(m["dec"].state_dict())
    got = _port_forward(dict(m, enc=enc, dec=dec))
    want = _port_forward(m)
    for g, w in zip(got[0] + list(got[1]), want[0] + list(want[1])):
        assert g.dtype == torch.float32
        scale = float(w.detach().abs().max())
        assert float((g - w).abs().max()) <= 5e-2 * scale


@pytest.mark.parametrize("norm", [None, "instance"])
def test_bfloat16_matches_jax_bfloat16(norm):
    """compute_dtype bfloat16 against the JAX package's bfloat16 models
    (``build_models`` with ``compute_dtype='bfloat16'``) on the same params
    and inputs: convs, bias adds and maxouts in bfloat16, InstanceNorm and
    the output head in float32.  Each skip and map of the port lies within
    a quarter of the port's float32 path's distance from the JAX package's
    (error norms; that distance, bfloat16's own rounding, is at least 1e-3
    of the norm: the option is in effect), and every block but the
    decoder's output head hands on bfloat16 activations.  Here the two
    agree bitwise: both sum exact bfloat16 products in float32 and round at
    the same points; another summation order may flip a rounding, which
    the later convs spread."""
    m = _model_pair(compute_dtype="bfloat16", norm_type=norm)
    enc32, dec32, _ = build_models(X, X, 2, Config(**{**KW, "norm_type": norm}))
    enc32.load_state_dict(m["enc"].state_dict())
    dec32.load_state_dict(m["dec"].state_dict())
    stored = []
    hooks = [blk.register_forward_hook(lambda mod, args, out: stored.append(out.dtype))
             for model in (m["enc"], m["dec"]) for blk in model.blocks]
    got = _port_forward(m)
    for h in hooks:
        h.remove()
    assert stored == [torch.bfloat16] * (len(stored) - 1) + [torch.float32]
    base = _port_forward(dict(m, enc=enc32, dec=dec32))
    want = _jax_forward(m)
    for g, f, w in zip(got[0] + list(got[1]), base[0] + list(base[1]),
                       list(want[0]) + list(want[1])):
        g, f, w = (np.asarray(v.detach() if torch.is_tensor(v) else v, np.float32) for v in (g, f, w))
        gap = float(np.linalg.norm(f - w))
        if g.shape[-1] == 4 and g.shape[1] == X:  # the input level: the input itself
            assert gap == 0 and np.array_equal(g, w)
            continue
        assert gap >= 1e-3 * float(np.linalg.norm(w))
        assert float(np.linalg.norm(g - w)) <= 0.25 * gap


# -- Beta and deterministic steps against JAX's elbo_loss ---------------------------

def _beta_log_gammas(m_params, jenc, jdec, batch, key, num_samples):
    """The log-gamma variates jax.random.beta draws inside elbo_loss (Beta
    latents and output) from ``key``, in the order the port asks for them:
    per level a then b, then the output's a and b, each (S*B, ...)."""
    skips = jenc.apply({"params": m_params["encoder"]}, batch["input_encode"] / 300.0)
    qs = [(jd.positive_range(loc), jd.positive_range(ls))
          for loc, ls in (jnp.split(s, 2, axis=-1) for s in skips)]
    key, _ = jax.random.split(key)
    per_sample = []
    for key_s in jax.random.split(key, num_samples):
        keys = jax.random.split(key_s, len(qs) + 2)
        draws, latents = [], []
        for (a, b), k in zip(qs, keys[:-2]):
            ka, kb = jax.random.split(k)
            la, lb = jax.random.loggamma(ka, a), jax.random.loggamma(kb, b)
            draws += [la, lb]
            latents.append(jax.random.beta(k, a, b))
        alpha, beta_p = jdec.apply({"params": m_params["decoder"]}, latents)
        ka, kb = jax.random.split(jax.random.fold_in(key_s, 7))
        draws += [jax.random.loggamma(ka, jd.positive_range(alpha)),
                  jax.random.loggamma(kb, jd.positive_range(beta_p))]
        per_sample.append(draws)
    return [jnp.concatenate([d[i] for d in per_sample]) for i in range(len(per_sample[0]))]


@pytest.mark.parametrize("mode", ["beta", "det"])
def test_beta_and_det_step_match_jax(mode, tmp_path):
    """One train step's loss and every gradient, Beta latents and output
    (use_normal false) or deterministic mode (--det), on the port's Trainer
    against the JAX package's elbo_loss on the same params, batch, angles
    and draws; loss to 1e-4, each gradient to 1e-3 of its leaf's largest."""
    over = dict(use_normal=False) if mode == "beta" else dict(deterministic=True)
    sinos, theta = _data()
    cfg = Config(**{**KW, **over, "pnm_start": None})
    tr = Trainer(cfg, sinos, theta, CPU)
    jcfg = JaxConfig(**{**KW, **over, "pnm_start": None})
    in_ch = tr.data["input_encode"].shape[-1]
    jenc, jdec, _ = jax_build_models(tr.x_size, tr.y_size, in_ch, jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tr.params_tree())
    bidx, aidx = np.array([2, 0]), np.array([7, 1, 4, 10, 5])
    batch = {k: jnp.asarray(v.numpy()[bidx]) for k, v in tr.data.items()}
    key = jax.random.PRNGKey(11)
    kw = dict(encoder=jenc, decoder=jdec, theta=jnp.asarray(theta), angles_i=jnp.asarray(aidx),
              kl_anneal=jnp.float32(1.0), kl_multiplier=1.0, pnm=jnp.float32(1e4), num_samples=2,
              use_normal=cfg.use_normal, deterministic=cfg.deterministic, num_blocks=2, pad=True,
              n_det=P, training=True)
    def reference(p):  # one compile: loss, gradients and the Beta draws
        (loss, _), grads = jax.value_and_grad(lambda q: jax_elbo_loss(q, batch, key, **kw),
                                              has_aux=True)(p)
        gammas = _beta_log_gammas(p, jenc, jdec, batch, key, 2) if mode == "beta" else []
        return loss, grads, gammas

    loss, grads, gammas = jax.jit(reference)(params)
    if mode == "beta":
        draws = Draws([], [], log_gamma=[torch.from_numpy(np.array(g)) for g in gammas])
    else:
        draws = jax_draws(key, [], (BATCH, X, X, 1), 2)
    got_loss, _, got = tr.loss_and_grads(torch.from_numpy(bidx), torch.from_numpy(aidx), draws)
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-4)
    named = iter(got)
    got_tree = {name: params_to_flax(mdl, {k: next(named) for k, _ in mdl.named_parameters()})
                for name, mdl in tr.models.items()}
    want = _np_tree(grads)
    for name in got_tree:
        for blk, leaves in want[name].items():
            for br, leaf in leaves.items():
                for k, w in leaf.items():
                    np.testing.assert_allclose(got_tree[name][blk][br][k], w, rtol=0,
                                               atol=1e-3 * np.abs(w).max() + 1e-12,
                                               err_msg=f"{mode} {name}/{blk}/{br}/{k}")


# -- train_pnm and steps_per_call against the JAX Trainer ------------------------

STEPS, SI = 11, 4
PNM_KW = dict(KW, train_pnm=True, num_iter=STEPS, save_interval=SI, steps_per_call=4)


@pytest.fixture(scope="module")
def jax_pnm_run(tmp_path_factory):
    """The JAX Trainer with train_pnm over 11 steps in chunks of 4 (a lax.scan
    per full chunk), checkpoints at save_interval 4, from its ckpt-0."""
    root = tmp_path_factory.mktemp("pnm")
    sinos, theta = _data(1)
    tr = JaxTrainer(JaxConfig(save_path=str(root / "jax"), **PNM_KW), sinograms=sinos, theta=theta)
    tr.checkpoint()
    params0 = _np_tree(tr.state.params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tr.metrics, "save_plots", lambda: None)
        tr.train()
    return dict(root=root, sinos=sinos, theta=theta, params0=params0,
                losses=np.asarray(tr.metrics.history["loss"]), params=_np_tree(tr.state.params),
                adam=_np_tree(tr.state.opt_state[1][0]))


def _port_pnm_trainer(run, name, sampler=True, ckpts=(0,), **over):
    """A port trainer restoring the JAX run's checkpoint ``ckpts[-1]``."""
    d = run["root"] / name
    (d / "training_checkpoints").mkdir(parents=True)
    for f in ("all_masks.npy", "all_proj_samples.npy", "all_input_encode.npy"):
        (d / f).write_bytes((run["root"] / "jax" / f).read_bytes())
    for n in ckpts:
        (d / "training_checkpoints" / f"ckpt-{n}.msgpack").write_bytes(
            (run["root"] / "jax" / "training_checkpoints" / f"ckpt-{n}.msgpack").read_bytes())
    cfg = Config(save_path=str(d), reuse_cache=True, restore=True, restore_num=ckpts[-1],
                 **{**PNM_KW, **over})
    tr = Trainer(cfg, run["sinos"], run["theta"], CPU, JaxTrainSampler(KW["seed"]) if sampler else None)
    tr.metrics.save_plots = lambda: None
    return tr, d


def test_train_pnm_chunked_trainer_matches_jax(jax_pnm_run):
    """train_pnm in 4-step chunks against the JAX Trainer's lax.scan chunks,
    on its draws: every loss (1e-4), log_pnm among the params (Adam moves
    every element by about lr whatever its gradient: all within 3 lr, 99.5%
    within 1e-5), log_pnm's Adam moments, and the checkpoints {1, 5, 9, 11}."""
    tr, d = _port_pnm_trainer(jax_pnm_run, "port")
    assert tr.step == 0 and "log_pnm" in tr.params_tree()
    tr.train()
    np.testing.assert_allclose(np.load(d / "train_loss_vec.npy"), jax_pnm_run["losses"], rtol=1e-4)
    st = tr.state_tree()
    got = np.concatenate([v.ravel() for v in _flat(st["params"])])
    want = np.concatenate([v.ravel() for v in _flat(jax_pnm_run["params"])])
    start = np.concatenate([v.ravel() for v in _flat(jax_pnm_run["params0"])])
    assert np.abs(got - want).max() <= 3 * LR
    assert np.mean(np.abs(got - want) <= 1e-5) >= 0.995
    assert abs(float(st["params"]["log_pnm"]) - float(jax_pnm_run["params0"]["log_pnm"])) > LR
    np.testing.assert_allclose(float(st["params"]["log_pnm"]), float(jax_pnm_run["params"]["log_pnm"]),
                               rtol=0, atol=1e-6)
    for which in ("mu", "nu"):
        np.testing.assert_allclose(st["opt_state"]["1"]["0"][which]["log_pnm"],
                                   getattr(jax_pnm_run["adam"], which)["log_pnm"], rtol=1e-3)
    assert np.median(np.abs(want - start)) > 100 * 1e-6
    assert sorted(os.listdir(d / "training_checkpoints")) == sorted(
        os.listdir(jax_pnm_run["root"] / "jax" / "training_checkpoints"))


def test_train_pnm_checkpoint_restores_both_ways(jax_pnm_run, tmp_path):
    """A port checkpoint with log_pnm restores in the JAX Trainer, and the
    JAX run's last one in the port, every leaf equal."""
    tr, d = _port_pnm_trainer(jax_pnm_run, "both")
    tr.train_step(np.array([0, 3]), np.arange(5), tr.sampler("train", 0, *tr.draw_shapes(BATCH), 2))
    tr.checkpoint()
    want = tr.state_tree()
    jtr = JaxTrainer(JaxConfig(save_path=str(d), reuse_cache=True, **PNM_KW),
                     sinograms=jax_pnm_run["sinos"], theta=jax_pnm_run["theta"])
    jtr.restore(use_latest=True)
    assert int(jtr.state.step) == 1
    _close_tree(_np_tree(jtr.state.params), want["params"], 0, 0)
    adam = _np_tree(jtr.state.opt_state[1][0])
    _close_tree(adam.mu, want["opt_state"]["1"]["0"]["mu"], 0, 0)
    _close_tree(adam.nu, want["opt_state"]["1"]["0"]["nu"], 0, 0)

    back, _ = _port_pnm_trainer(jax_pnm_run, "back", ckpts=(STEPS,))
    st = back.state_tree()
    assert int(st["step"]) == STEPS
    _close_tree(st["params"], jax_pnm_run["params"], 0, 0)
    _close_tree(st["opt_state"]["1"]["0"]["mu"], jax_pnm_run["adam"].mu, 0, 0)


def test_steps_per_call_chunks_train_as_single_steps(jax_pnm_run):
    """The port's own draws: K = 1 and K = 4 over 11 steps with save_interval
    4 give bitwise the same params, losses and checkpoints {1, 5, 9, 11} (the
    chunk stages the same slots and re-seeds the generator per step)."""
    runs = {}
    for spc in (1, 4):
        tr, d = _port_pnm_trainer(jax_pnm_run, f"spc{spc}", sampler=False, steps_per_call=spc)
        tr.train()
        runs[spc] = (tr.state_tree(), np.load(d / "train_loss_vec.npy"),
                     sorted(os.listdir(d / "training_checkpoints")))
    (s1, l1, c1), (s4, l4, c4) = runs[1], runs[4]
    assert len(l1) == len(l4) == STEPS
    np.testing.assert_array_equal(l1, l4)
    _close_tree(s4["params"], s1["params"], 0, 0)
    _close_tree(s4["opt_state"], s1["opt_state"], 0, 0)
    assert c1 == c4 == sorted(["ckpt-0.msgpack"] + [f"ckpt-{n}.msgpack" for n in (1, 5, 9, 11)])


# -- the options through cli train (and cli infer), and profile_steps ------------------

OPTIONS = {
    "beta": [],
    "det": ["--det"],
    "dropout": ["--dp", "0.1"],
    "instance": ["--norm_type", "instance"],
    "train_pnm": ["--train_pnm"],
    "subpixel": ["--conv_impl", "subpixel"],
    "im2col": ["--conv_impl", "im2col"],
    "bfloat16": ["--compute_dtype", "bfloat16"],
}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    sinos, theta = _data(2)
    np.save(d / "x_train_sinograms.npy", sinos)
    np.save(d / "dataset_parameters.npy", np.array([theta, P], dtype=object))
    return d


@pytest.mark.parametrize("option", list(OPTIONS))
def test_cli_trains_each_option(option, dataset, tmp_path, capsys):
    """Each option trains 9 steps through ``cli train`` on the CPU (a 1-step
    chunk, then two chunks of 4) with finite losses and a checkpoint; Beta
    and --det runs then serve through ``cli infer``."""
    run = tmp_path / "run"
    args = ["train", "--input_path", str(dataset), "--save_path", str(run), "--train", "-b", "2",
            "--td", "4", "-i", "9", "--nsa", "6", "--api", "5", "--random", "--algorithms", "fbp",
            "--nb", "2", "--nfm", "4", "--il", "1", "--spc", "4", "--device", "cpu"]
    args += OPTIONS[option] + ([] if option == "beta" else ["--normal"])
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert np.isfinite(float(out.split("Average loss final : ")[1].split()[0]))
    losses = np.load(run / "train_loss_vec.npy")
    assert losses.shape == (9,) and np.isfinite(losses).all()
    assert (run / "training_checkpoints" / "ckpt-9.msgpack").exists()
    if option in ("beta", "det"):
        assert cli.main(["infer", "--run_path", str(run), "--input_path", str(dataset), "--output",
                         str(tmp_path / "out"), "--cheap_init", "--passes", "2", "--device", "cpu"]) == 0
        mean = np.load(tmp_path / "out" / "reconstruction_mean.npy")
        assert mean.shape == (N, X, X, 1) and np.isfinite(mean).all()


def test_profile_steps_leaves_a_trace(tmp_path):
    """profile_steps 2: steps 2 and 3 of 5 traced into <save_path>/profile,
    with the port's spans of the traced steps in it."""
    sinos, theta = _data()
    cfg = Config(**{**KW, "num_iter": 5, "profile_steps": 2, "save_path": str(tmp_path)})
    tr = Trainer(cfg, sinos, theta, CPU)
    tr.metrics.save_plots = lambda: None
    tr.train()
    with open(tmp_path / "profile" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("convolution" in e.get("name", "") for e in events)
    spans = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert any(n in ("ctpvae.train.chunk", "ctpvae.train.step") for n in spans)
    assert np.load(tmp_path / "train_loss_vec.npy").shape == (5,)


@pytest.mark.parametrize("spc, profile_steps, want", [
    (4, 4, [1, 1, 4, 4, 1, 1]),  # the traced steps [2, 6): one chunk
    (4, 2, [1, 1, 1, 1, 4, 4]),  # [2, 4): a part of a chunk, step by step
    (1, 3, [1] * 12),
])
def test_profile_steps_cut_the_chunks(tmp_path, monkeypatch, spc, profile_steps, want):
    """Chunks are cut where the trace begins and ends (steps 2 and 2 +
    profile_steps), as at save boundaries: a whole chunk runs through
    ``train_chunk``, a part of one step by step."""
    sinos, theta = _data()
    cfg = Config(**{**KW, "num_iter": 12, "profile_steps": profile_steps, "steps_per_call": spc,
                    "save_path": str(tmp_path)})
    tr = Trainer(cfg, sinos, theta, CPU)
    tr.metrics.save_plots = lambda: None
    runs = []
    chunk, step = tr.train_chunk, tr.train_step
    monkeypatch.setattr(tr, "train_chunk", lambda b, *a: runs.append(len(b)) or chunk(b, *a))
    monkeypatch.setattr(tr, "train_step", lambda *a: runs.append(1) or step(*a))
    tr.train()
    # step 0 alone (a save boundary), then chunks that stop at each cut
    assert runs == want
    assert (tmp_path / "profile" / "trace.json").exists()
