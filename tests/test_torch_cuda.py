"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without an NVIDIA GPU (and nvcc).  On a machine
with one: ``python -m pytest tests/test_torch_cuda.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

from ct_pvae_tpu_torch.ops import joseph_radon as jr

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n, n_det, n_angles, batch", [(32, 48, 12, 3), (128, 184, 180, 20), (128, 184, 20, 20)])
def test_joseph_kernel_matches_plain(cuda, n, n_det, n_angles, batch):
    rng = np.random.default_rng(n_angles)
    theta = np.linspace(0, np.pi, 180, endpoint=False)
    idx = np.sort(rng.choice(180, n_angles, replace=False))
    table = torch.as_tensor(jr.angle_table_fused(theta, n, n, n_det)[idx], device=cuda)
    img = torch.as_tensor(rng.uniform(0, 1, (batch, n, n)).astype(np.float32), device=cuda)
    before = jr.LAUNCHES["joseph_fwd"]
    out = jr.radon_fused(img, table, n_det)
    torch.cuda.synchronize()
    assert jr.LAUNCHES["joseph_fwd"] == before + 1
    ref = jr.radon_fused_plain(img, table, n_det)
    # same taps, another summation order
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


def test_joseph_kernel_rejects_non_contiguous(cuda):
    table = torch.as_tensor(jr.angle_table_fused(np.zeros(1), 8, 8, 12), device=cuda)
    img = torch.zeros((2, 8, 8), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        jr.radon_fused(img, table, 12)


def _table(n, n_det, n_angles, seed, cuda):
    rng = np.random.default_rng(seed)
    theta = np.linspace(0, np.pi, 180, endpoint=False)
    idx = np.sort(rng.choice(180, n_angles, replace=False))
    return torch.as_tensor(jr.angle_table_fused(theta, n, n, n_det)[idx], device=cuda)


@pytest.mark.parametrize("n, n_det, n_angles, batch", [(32, 48, 12, 3), (128, 184, 20, 20), (184, 184, 180, 32)])
def test_adjoint_kernel_matches_plain_and_is_the_transpose(cuda, n, n_det, n_angles, batch):
    """Kernel B (and D, the same entry point on the full table) against its
    plain version, and <A x, g> = <x, A^T g> between kernels A and B."""
    rng = np.random.default_rng(n)
    table = _table(n, n_det, n_angles, n, cuda)
    g = torch.as_tensor(rng.normal(size=(batch, n_angles, n_det)).astype(np.float32), device=cuda)
    x = torch.as_tensor(rng.uniform(0, 1, (batch, n, n)).astype(np.float32), device=cuda)
    before = jr.LAUNCHES["joseph_adj"]
    out = jr.radon_fused_adjoint(g, table, n)
    torch.cuda.synchronize()
    assert jr.LAUNCHES["joseph_adj"] == before + 1
    ref = jr.radon_fused_adjoint_plain(g, table, n)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    lhs = (jr.radon_fused(x, table, n_det).double() * g.double()).sum()
    rhs = (x.double() * out.double()).sum()
    assert abs(float(lhs - rhs)) <= 1e-5 * abs(float(lhs))


def test_static_pair_and_autograd_on_the_card(cuda):
    """Kernels C and D through radon_static / backproject_static, counted
    apart, and radon_fused's backward launching kernel B."""
    theta = tuple(float(t) for t in np.linspace(0, np.pi, 180, endpoint=False))
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.uniform(0, 1, (4, 184, 184)).astype(np.float32), device=cuda)
    s = torch.as_tensor(rng.uniform(0, 1, (4, 180, 184)).astype(np.float32), device=cuda)
    before = dict(jr.LAUNCHES)
    fwd = jr.radon_static(x, theta, 184)
    adj = jr.backproject_static(s, theta, 184, 184)
    torch.cuda.synchronize()
    assert jr.LAUNCHES["joseph_fwd_static"] == before["joseph_fwd_static"] + 1
    assert jr.LAUNCHES["joseph_adj_static"] == before["joseph_adj_static"] + 1
    x_cpu, s_cpu = x.cpu(), s.cpu()
    torch.testing.assert_close(fwd.cpu(), jr.radon_static(x_cpu, theta, 184), rtol=1e-5,
                               atol=1e-5 * float(fwd.abs().max()))
    torch.testing.assert_close(adj.cpu(), jr.backproject_static(s_cpu, theta, 184, 184), rtol=1e-5,
                               atol=1e-5 * float(adj.abs().max()))
    table = _table(128, 184, 20, 1, cuda)
    img = torch.rand((20, 128, 128), device=cuda, requires_grad=True)
    w = torch.rand((20, 20, 184), device=cuda)
    (jr.radon_fused(img, table, 184) * w).sum().backward()
    torch.cuda.synchronize()
    assert jr.LAUNCHES["joseph_adj"] == before["joseph_adj"] + 1
    torch.testing.assert_close(img.grad, jr.radon_fused_adjoint_plain(w, table, 128), rtol=1e-5,
                               atol=1e-5 * float(img.grad.abs().max()))
