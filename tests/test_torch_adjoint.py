"""The port's Joseph adjoint (kernel B's plain version), the static pair
(kernels C and D) and SIRT/TV against the JAX package's Pallas kernels, run
in interpret mode on the CPU."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_pvae_tpu.ops import pallas_radon as pr
from ct_pvae_tpu_torch.ops import joseph_radon as jr
from ct_pvae_tpu_torch.ops import sirt, tv

# the package re-exports the functions sirt() and tv_reconstruct() over the module names
jsirt = importlib.import_module("ct_pvae_tpu.ops.sirt")
jtv = importlib.import_module("ct_pvae_tpu.ops.tv")

N, N_DET, B = 32, 48, 3


def _subset_table():
    """12 of 180 uniform angles, both major axes represented."""
    theta = np.linspace(0, np.pi, 180, endpoint=False)
    idx = np.random.default_rng(3).choice(180, 12, replace=False)
    table = pr.angle_table_fused(theta, N, N, N_DET)[idx]
    assert 0 < table[:, 4].sum() < 12
    return table


def _static_theta(a=10):
    return tuple(float(t) for t in np.sort(np.random.default_rng(4).uniform(0, np.pi, a)))


def _rand(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def test_plain_adjoint_matches_fused_adj_and_is_the_transpose():
    table = _subset_table()
    x, g = _rand((B, N, N), 0), np.random.default_rng(1).normal(size=(B, 12, N_DET)).astype(np.float32)
    ref = np.asarray(pr._fused_adj_impl(jnp.asarray(g), jnp.asarray(table), N, N, True))
    out = jr.radon_fused_adjoint_plain(torch.from_numpy(g), torch.from_numpy(table), N).numpy()
    assert out.shape == ref.shape == (B, N, N)
    # same taps, another summation order: 1e-5 of the largest value
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    ax = jr.radon_fused_plain(torch.from_numpy(x), torch.from_numpy(table), N_DET).numpy()
    lhs = np.sum(ax.astype(np.float64) * g)
    rhs = np.sum(x.astype(np.float64) * out)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5)


def test_autograd_gradient_matches_jax_grad():
    """The backward of radon_fused (the plain adjoint on the CPU) against
    jax.grad through radon_pallas_fused's custom VJP (kernel B)."""
    table = _subset_table()
    x, w = _rand((B, N, N), 2), _rand((B, 12, N_DET), 3)
    xt = torch.from_numpy(x).requires_grad_()
    (jr.radon_fused(xt, torch.from_numpy(table), N_DET) * torch.from_numpy(w)).sum().backward()
    ref = jax.grad(lambda im: jnp.sum(pr.radon_pallas_fused(im, jnp.asarray(table), N_DET, True) * w))(
        jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ref)).max())


def test_static_pair_matches_radon_pallas_and_backproject_pallas():
    theta = _static_theta()
    x, s = _rand((B, N, N), 4), _rand((B, len(theta), N_DET), 5)
    fwd = jr.radon_static(torch.from_numpy(x), theta, N_DET).numpy()
    fwd_ref = np.asarray(pr.radon_pallas(jnp.asarray(x), theta, N_DET, True))
    np.testing.assert_allclose(fwd, fwd_ref, rtol=1e-5, atol=1e-5 * np.abs(fwd_ref).max())
    adj = jr.backproject_static(torch.from_numpy(s), theta, N, N).numpy()
    adj_ref = np.asarray(pr.backproject_pallas(jnp.asarray(s), theta, N, N, True))
    np.testing.assert_allclose(adj, adj_ref, rtol=0, atol=1e-5 * np.abs(adj_ref).max())
    # and the static forward's gradient is the static adjoint
    xt = torch.from_numpy(x).requires_grad_()
    (jr.radon_static(xt, theta, N_DET) * torch.from_numpy(s)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), adj, rtol=1e-6, atol=1e-6 * np.abs(adj).max())


def test_static_pair_rejects_non_square_and_counts_no_cpu_launch():
    theta = _static_theta(4)
    with pytest.raises(ValueError, match="square"):
        jr.radon_static(torch.zeros((1, 8, 9)), theta, 12)
    with pytest.raises(ValueError, match="square"):
        jr.backproject_static(torch.zeros((1, 4, 12)), theta, 8, 9)
    before = dict(jr.LAUNCHES)
    jr.backproject_static(torch.zeros((1, 4, 12)), theta, 8, 8)
    jr.radon_static(torch.zeros((1, 8, 8)), theta, 12)
    assert jr.LAUNCHES == before


@pytest.mark.parametrize("alg", ["sirt", "tv"])
def test_iterative_recon_matches_jax_on_the_joseph_pair(alg):
    """sirt_with_ops / tv_with_ops, each driven by its side's static Joseph
    pair, as the JAX package's TPU route drives them (recon_init.py:144-153)."""
    theta = _static_theta(16)
    sino = np.array(pr.radon_pallas(jnp.asarray(_rand((2, N_DET, N_DET), 6)), theta, N_DET, True))
    jfwd = lambda im: pr.radon_pallas(im, theta, N_DET, True)
    jadj = lambda sg: pr.backproject_pallas(sg, theta, N_DET, N_DET, True)
    tfwd = lambda im: jr.radon_static(im, theta, N_DET)
    tadj = lambda sg: jr.backproject_static(sg, theta, N_DET, N_DET)
    if alg == "sirt":
        ref = jsirt.sirt_with_ops(jnp.asarray(sino), jfwd, jadj, N_DET, N_DET, num_iter=8)
        out = sirt.sirt_with_ops(torch.from_numpy(sino), tfwd, tadj, N_DET, N_DET, num_iter=8)
    else:
        ref = jtv.tv_with_ops(jnp.asarray(sino), jfwd, jadj, N_DET, N_DET, num_iter=8)
        out = tv.tv_with_ops(torch.from_numpy(sino), tfwd, tadj, N_DET, N_DET, num_iter=8)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_tv_grad_and_div_match_jax():
    x = _rand((2, 7, 9), 7)
    gx, gy = tv._grad(torch.from_numpy(x))
    jgx, jgy = jtv._grad(jnp.asarray(x))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jgy))
    np.testing.assert_allclose(tv._div(gx, gy).numpy(), np.asarray(jtv._div(jgx, jgy)), rtol=0, atol=1e-6)
