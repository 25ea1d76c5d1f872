"""Shared fixtures of the benchmark's tests: the checkout on ``sys.path``, a
small size of each configuration for the CPU, and the card where a test needs it."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    """Share the cores among pytest-xdist's workers: torch's intra-op threads
    of several workers on the same cores slow each other down by far more
    than the share."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))

# 47 x 47 reconstructions from 48 x 48 objects onto 70 bins (the Joseph route
# needs 64 bins or more), 12 angles, batches of 4, the published widths
SMALL = {"config": {"objects": 16, "n_pixel": 48, "num_angles": 12, "truncate_dataset": 16,
                    "batch_size": 4, "num_sparse_angles": 4, "angles_per_iter": 4},
         "traffic": {"scans": 8, "trace_after_s": 0.0, "trace_units": 1}}


@pytest.fixture
def small():
    return SMALL


@pytest.fixture
def kernel_route(monkeypatch):
    """Training and serving on the CPU through the Joseph projector's plain
    version, as the card runs kernels A and B (the CPU otherwise takes the
    gather projector, another discretisation)."""
    import ct_pvae_tpu_torch.vi.serve as serve

    route = serve.joseph_route
    monkeypatch.setattr(serve, "joseph_route",
                        lambda cfg, n_det, device, kernel_route=False, mesh=None, num_angles=None:
                        route(cfg, n_det, device, True, mesh, num_angles))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the chip)")
    return torch.device("cuda")
