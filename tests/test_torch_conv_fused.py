"""Kernel E's plain version (``ops/conv_fused.py``) and the port of its probe
against the JAX package's ``ConvBlock(F, 3, 1)`` on the CPU, with the flax
block's params carried over by ``maxout_params_from_flax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_pvae_tpu.models.pvae import ConvBlock
from ct_pvae_tpu_torch.ops import conv_fused
from ct_pvae_tpu_torch.scripts import probe_conv_fused as probe

SHAPES = [(2, 16, 16, 5, 7), (2, 12, 10, 3, 4)]  # (B, H, W, C, F); the second ragged


def _flax_block(b, h, w, c, f, impl):
    """A JAX ConvBlock's params (seeded init) and its output on a numpy input."""
    x = np.random.default_rng(h * w + c).normal(size=(b, h, w, c)).astype(np.float32)
    block = ConvBlock(features=f, kernel=3, stride=1, impl=impl)
    params = block.init(jax.random.PRNGKey(c), jnp.asarray(x))["params"]
    # non-zero biases, so the carry-over of both halves' biases is tested
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(1), p.shape) if p.ndim == 1 else p,
        params)
    out = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    return x, jax.tree_util.tree_map(np.asarray, params), out


@pytest.mark.parametrize("impl", ["direct", "im2col"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax_conv_block(shape, impl):
    x, params, ref = _flax_block(*shape, impl)
    kern, bias = conv_fused.maxout_params_from_flax(params)
    assert kern.shape == (3, 3, shape[3], 2 * shape[4]) and bias.shape == (2 * shape[4],)
    before = conv_fused.LAUNCHES["conv_fused_maxout"]
    out = conv_fused.conv3x3_periodic_maxout(*map(torch.from_numpy, (x, kern, bias))).numpy()
    assert conv_fused.LAUNCHES["conv_fused_maxout"] == before  # a CPU tensor launches nothing
    assert out.shape == ref.shape == shape[:3] + (shape[4],)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_probe_formulations_agree_on_the_cpu(shape):
    """The probe's cudnn and im2col formulations (here on the CPU's own conv
    and matmul) against the JAX ConvBlock, on the probe's own draws."""
    b, h, w, c, f = shape
    x, params, ref = _flax_block(*shape, "direct")
    tensors = [torch.from_numpy(a) for a in (x, *conv_fused.maxout_params_from_flax(params))]
    for name in ("cudnn", "im2col"):
        out = probe.FORMULATIONS[name](*tensors).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5, err_msg=name)
    xp, kp, bp = probe.probe_inputs(b, h, c, f, 3, torch.device("cpu"))
    rng = np.random.default_rng(0)  # the JAX probe's draws, in its order
    np.testing.assert_array_equal(xp.numpy(), rng.normal(size=(b, h, h, c)).astype(np.float32))
    np.testing.assert_array_equal(kp.numpy(), rng.normal(size=(3, 3, c, 2 * f)).astype(np.float32) * 0.1)
    np.testing.assert_array_equal(bp.numpy(), rng.normal(size=(2 * f,)).astype(np.float32) * 0.1)
    np.testing.assert_allclose(probe.f_cudnn(xp, kp, bp).numpy(),
                               conv_fused.conv3x3_periodic_maxout(xp, kp, bp).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_wrapper_is_forward_only_and_checks_shapes():
    x, kern, bias = (torch.zeros(s) for s in ((1, 4, 4, 2), (3, 3, 2, 6), (6,)))
    with pytest.raises(RuntimeError, match="forward only"):
        conv_fused.conv3x3_periodic_maxout(x.requires_grad_(), kern, bias)
    with torch.no_grad():  # no graph is built, so nothing is cut off
        assert conv_fused.conv3x3_periodic_maxout(x, kern, bias).shape == (1, 4, 4, 3)
    with pytest.raises(ValueError, match="kern"):
        conv_fused.conv3x3_periodic_maxout(x.detach(), kern[:2], bias)
    with pytest.raises(TypeError, match="float32"):
        conv_fused.conv3x3_periodic_maxout(x.detach().double(), kern, bias)


def test_probe_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main([]) == 1
    assert "CUDA" in capsys.readouterr().err
