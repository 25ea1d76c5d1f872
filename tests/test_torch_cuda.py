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
