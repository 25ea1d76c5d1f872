"""Port's fused Joseph projector (ct_pvae_tpu_torch/ops/joseph_radon.py)
against the JAX package's kernel A, ``radon_pallas_fused``, run in Pallas
interpret mode on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_pvae_tpu.ops import pallas_radon as pr
from ct_pvae_tpu.ops.radon import pad_phantom as jax_pad_phantom
from ct_pvae_tpu_torch.ops import joseph_radon as jr
from ct_pvae_tpu_torch.ops.radon import num_proj_pixels, pad_phantom

N, N_DET = 32, 48


def _angles():
    """12 of 180 uniform angles, both major axes represented."""
    theta_all = np.linspace(0, np.pi, 180, endpoint=False)
    idx = np.random.default_rng(3).choice(180, 12, replace=False)
    table = pr.angle_table_fused(theta_all, N, N, N_DET)
    assert 0 < table[idx, 4].sum() < 12  # x-major and y-major rows both present
    return theta_all, idx


def test_angle_table_fused_bitwise():
    theta = np.linspace(0, np.pi, 180, endpoint=False)
    for hw, n_det in ((N, N_DET), (128, 184), (N_DET, N_DET)):
        ours = jr.angle_table_fused(theta, hw, hw, n_det)
        ref = pr.angle_table_fused(theta, hw, hw, n_det)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


def test_plain_matches_pallas_fused():
    theta, idx = _angles()
    table = pr.angle_table_fused(theta, N, N, N_DET)[idx]
    img = np.random.default_rng(0).uniform(0, 1, (3, N, N)).astype(np.float32)
    ref = np.asarray(pr.radon_pallas_fused(jnp.asarray(img), jnp.asarray(table), N_DET, True))
    out = jr.radon_fused_plain(torch.from_numpy(img), torch.from_numpy(table), N_DET).numpy()
    assert out.shape == ref.shape == (3, 12, N_DET)
    # same taps, another summation order: rtol 1e-5 plus 1e-5 of the largest value
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_unpadded_table_equals_padded_projection():
    """A table for the unpadded 32^2 recon projects onto the 48-pixel detector
    exactly as the padded 48^2 image does (test_pallas_radon.py:164-190)."""
    assert num_proj_pixels(N, N) == N_DET
    theta = np.linspace(0, np.pi, 23, endpoint=False)
    img = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, N, N)).astype(np.float32))
    t_img = torch.from_numpy(jr.angle_table_fused(theta, N, N, N_DET))
    t_pad = torch.from_numpy(jr.angle_table_fused(theta, N_DET, N_DET, N_DET))
    padded = pad_phantom(img, N_DET)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jax_pad_phantom(jnp.asarray(img.numpy()), N_DET)))
    out = jr.radon_fused_plain(img, t_img, N_DET)
    ref = jr.radon_fused_plain(padded, t_pad, N_DET)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-4)


def test_radon_fused_cpu_tensor_takes_plain_version():
    theta, idx = _angles()
    table = torch.from_numpy(jr.angle_table_fused(theta, N, N, N_DET)[idx])
    img = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, N, N)).astype(np.float32))
    before = dict(jr.LAUNCHES)
    out = jr.radon_fused(img, table, N_DET)
    assert jr.LAUNCHES == before  # no kernel launch for a CPU tensor
    assert torch.equal(out, jr.radon_fused_plain(img, table, N_DET))


@pytest.mark.parametrize(
    "image, table",
    [
        (torch.zeros((2, 8, 9)), torch.zeros((4, 5))),                      # not square
        (torch.zeros((2, 8, 8), dtype=torch.float64), torch.zeros((4, 5))),  # not float32
        (torch.zeros((2, 8, 8)), torch.zeros((4, 4))),                      # table not (A, 5)
    ],
)
def test_radon_fused_rejects_bad_inputs(image, table):
    with pytest.raises((ValueError, TypeError)):
        jr.radon_fused(image, table, 12)
