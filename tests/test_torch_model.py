"""Port's checkpoint reader, distributions and P-VAE encoder/decoder against
flax and the JAX package on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ct_pvae_tpu.config import Config as JaxConfig
from ct_pvae_tpu.models.pvae import build_models as jax_build_models
from ct_pvae_tpu.prob import distributions as jd
from ct_pvae_tpu_torch.config import Config
from ct_pvae_tpu_torch.data.io import load_dataset
from ct_pvae_tpu_torch.data.masks import make_masks
from ct_pvae_tpu_torch.data.recon_init import classical_recon_stack
from ct_pvae_tpu_torch.models.pvae import build_models, params_from_flax
from ct_pvae_tpu_torch.prob import distributions as td
from ct_pvae_tpu_torch.utils.flax_msgpack import load_checkpoint, msgpack_restore, msgpack_serialize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4 = os.path.join(REPO, "results", "foam_paper_run_r4")
CKPT = os.path.join(R4, "ckpt-100000.msgpack")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_msgpack_reader_matches_flax():
    with open(CKPT, "rb") as f:
        raw = f.read()
    ours = dict(_leaves(msgpack_restore(raw)))
    ref = dict(_leaves(serialization.msgpack_restore(raw)))
    assert set(ours) == set(ref) and len(ref) == 232
    for k, r in ref.items():
        o = ours[k]
        assert o.dtype == r.dtype and o.shape == r.shape and o.tobytes() == r.tobytes(), k


def test_msgpack_reader_round_trip_and_rejects_unknown_ext():
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3), "b": {"c": np.float32(1.5) * np.ones(3, np.float32)},
            "s": "text", "n": None, "t": True, "i": -7, "big": 2**40, "f": 0.25, "l": [1, 2]}
    out = msgpack_restore(serialization.msgpack_serialize(tree))
    np.testing.assert_array_equal(out["a"], tree["a"])
    np.testing.assert_array_equal(out["b"]["c"], tree["b"]["c"])
    assert {k: out[k] for k in ("s", "n", "t", "i", "big", "f", "l")} == {
        k: tree[k] for k in ("s", "n", "t", "i", "big", "f", "l")}
    with pytest.raises(ValueError, match="ext type 2"):
        msgpack_restore(serialization.msgpack_serialize({"z": 1 + 2j}))


def test_msgpack_writer_matches_flax():
    """The port's writer gives flax's bytes for a tree of every kind it
    writes (flax orders map keys, as jax pytrees do), and re-encodes the r4
    checkpoint bitwise."""
    tree = {"a": np.arange(6, dtype=np.int32).reshape(2, 3), "b": {"c": np.ones(40, np.float32),
            "e": {}}, "big": np.zeros(20000, np.float32), "f": 0.25, "i": -1000, "k": 300,
            "n": None, "s": "x" * 40, "t": True, "z": np.ones((), np.float32)}
    assert msgpack_serialize(tree) == serialization.msgpack_serialize(tree)
    with open(CKPT, "rb") as f:
        raw = f.read()
    assert msgpack_serialize(msgpack_restore(raw)) == raw


def test_distributions_match_jax():
    rng = np.random.default_rng(0)
    loc = rng.normal(0, 1.5, (4, 9)).astype(np.float32)
    raw = rng.normal(0, 1.5, (4, 9)).astype(np.float32)
    eps = rng.normal(size=(4, 9)).astype(np.float32)
    u = rng.uniform(td.EPS, 1 - td.EPS, (4, 9)).astype(np.float32)
    x = rng.uniform(0, 2, (4, 9)).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    j = lambda a: jnp.asarray(a)
    scale_t, scale_j = td.positive_range(t(raw)), jd.positive_range(j(raw))
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    close(scale_t, scale_j)
    nt, nj = td.Normal(t(loc), scale_t), jd.Normal(j(loc), scale_j)
    close(nt.log_prob(t(x)), nj.log_prob(j(x)))
    close(nt.sample(t(eps)), j(loc) + scale_j * j(eps))
    prior_t = td.Normal(torch.zeros(4, 9), torch.ones(4, 9))
    prior_j = jd.Normal(jnp.zeros((4, 9)), jnp.ones((4, 9)))
    close(td.kl_normal_normal(nt, prior_t), jd.kl_divergence(nj, prior_j))
    tt = td.TruncatedNormal(td.positive_range(t(loc)), scale_t, 0.0, 1e10)
    tj = jd.TruncatedNormal(jd.positive_range(j(loc)), scale_j, jnp.float32(0.0), jnp.float32(1e10))
    close(tt.log_prob(t(x)), tj.log_prob(j(x)))
    close(tt.mean(), tj.mean())
    # inverse-CDF sampling on shared uniforms, as TruncatedNormal.sample does
    a, b = tj._alpha_beta()
    fa, fb = jax.scipy.special.ndtr(a), jax.scipy.special.ndtr(b)
    q = jnp.clip(fa + j(u) * (fb - fa), td.EPS, 1 - td.EPS)
    ref = jnp.clip(tj.loc + tj.scale * jax.scipy.special.ndtri(q), 0.0, 1e10)
    np.testing.assert_allclose(tt.sample(t(u)).numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def _compare_models(cfg_j, cfg_t, params, hw, in_ch, x, atol, rtol):
    enc_j, dec_j, shapes = jax_build_models(hw, hw, in_ch, cfg_j)
    enc, dec, shapes_t = build_models(hw, hw, in_ch, cfg_t)
    assert [tuple(s) for s in shapes] == shapes_t
    enc.load_state_dict(params_from_flax(params["encoder"]))
    dec.load_state_dict(params_from_flax(params["decoder"]))
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    skips_j = enc_j.apply({"params": pj["encoder"]}, jnp.asarray(x))
    with torch.no_grad():
        skips = enc(torch.from_numpy(x))
    for sj, st in zip(skips_j, skips):
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=rtol, atol=atol)
    lat = [np.array(jnp.split(s, 2, axis=-1)[0]) for s in skips_j]
    mean_j, var_j = dec_j.apply({"params": pj["decoder"]}, [jnp.asarray(z) for z in lat])
    with torch.no_grad():
        mean, var = dec([torch.from_numpy(z) for z in lat])
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=rtol, atol=atol)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), rtol=rtol, atol=atol)


def test_paper_width_model_on_r4_weights():
    """Full foam-paper width (5 inputs, nb 3, nfm 20, ks 4, se 2, il 2, ik 4)
    on the trained r4 weights, one 128^2 example.  A transpose conv loaded
    with the wrong orientation fails here by orders of magnitude."""
    cfg_j = JaxConfig.load(os.path.join(R4, "config.json"))
    cfg_t = Config.load(os.path.join(R4, "config.json"))
    params = load_checkpoint(CKPT)["params"]
    # encoder input as served: the cheap-init stack of dataset_foam's first
    # sinogram (its un-noised sparse measurement), over the 1/300 input scale
    sino, theta, _ = load_dataset(os.path.join(REPO, "dataset_foam"))
    sino = np.asarray(sino[:1], np.float32)
    m = make_masks(1, len(theta), cfg_t.num_sparse_angles, random=True)
    stack = classical_recon_stack(sino * m[:, :, None], m, theta, cfg_t.algorithms, 128, 128,
                                  torch.device("cpu"), cheap_init=True)
    x = stack / np.float32(cfg_t.input_encode_scale)
    # atol 1e-4 plus rtol 1e-5: the decoder's raw (pre-positive_range) output
    # reaches |750| on this input, where float32 spacing alone is 6e-5
    _compare_models(cfg_j, cfg_t, params, 128, 5, x, atol=1e-4, rtol=1e-5)


def test_random_params_model_at_32():
    kw = dict(num_blocks=2, num_feature_maps=6, kernel_size=4, stride_encode=2,
              intermediate_layers=1, intermediate_kernel=3, algorithms=["fbp", "gridrec"])
    cfg_j, cfg_t = JaxConfig(**kw), Config(**kw)
    enc_j, dec_j, _ = jax_build_models(32, 32, 3, cfg_j)
    x = np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    p_enc = enc_j.init({"params": k1}, jnp.asarray(x))["params"]
    lat = [jnp.split(s, 2, axis=-1)[0] for s in enc_j.apply({"params": p_enc}, jnp.asarray(x))]
    p_dec = dec_j.init({"params": k2}, lat)["params"]
    params = jax.tree_util.tree_map(np.asarray, {"encoder": p_enc, "decoder": p_dec})
    _compare_models(cfg_j, cfg_t, params, 32, 3, x, atol=1e-4, rtol=1e-5)
