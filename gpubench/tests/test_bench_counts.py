"""The frozen yardstick: model FLOPs against a hand count, Joseph counts against PERF.md section 6."""

import numpy as np
import pytest

from gpubench.counts import (bound_seconds, eval_pass_flops, init_applications, joseph_bound,
                             joseph_cost, joseph_taps_per_image, train_step_flops)
from gpubench.reference.pvae import model_sizes

WIDTHS = dict(kernel_size=4, stride_encode=2, intermediate_layers=2, intermediate_kernel=4,
              num_feature_maps=20, num_feature_maps_multiplier=1.1, num_blocks=3)


def test_flops_of_a_one_level_model_by_hand():
    # 8 x 8 objects -> 14 bins -> a 7 x 7 reconstruction, one algorithm + mask (2 channels)
    cfg = dict(kernel_size=2, stride_encode=2, intermediate_layers=1, intermediate_kernel=3,
               num_feature_maps=3, num_feature_maps_multiplier=1.0, num_blocks=1,
               n_pixel=8, algorithms=["gridrec"])
    sizes = model_sizes(cfg)
    assert sizes.x == 7
    # encoder: 4 -> 4 (2F 8) 3x3 at 7x7; 4 -> 6 (2F 12) 2x2 stride 2 -> 4x4
    enc = [7 * 7 * 4 * 8 * 9, 4 * 4 * 4 * 12 * 4]
    # decoder: latent 3 ch at 4x4 -> transposed 3 -> 4 (2F 8) 2x2 to 8x8; 4 -> 4 (8) 3x3 at
    # 8x8; crop to 7x7; head 4 -> 2 (4) 2x2 at 7x7
    dec = [4 * 4 * 3 * 8 * 4, 8 * 8 * 4 * 8 * 9, 7 * 7 * 4 * 4 * 4]
    b, s = 3, 2
    assert eval_pass_flops(sizes, b, s) == 2 * (b * sum(enc) + b * s * sum(dec))
    assert train_step_flops(sizes, b, s) == 2 * (b * (3 * sum(enc) - enc[0]) + b * s * 3 * sum(dec))


def test_flops_of_the_cells():
    paper = model_sizes(dict(WIDTHS, n_pixel=128, algorithms=["sirt", "tv", "fbp", "gridrec"]))
    stretch = model_sizes(dict(WIDTHS, n_pixel=512, algorithms=["gridrec"]))
    assert train_step_flops(paper, 10, 2) == 145_919_836_160
    assert train_step_flops(stretch, 4, 2) == 784_905_273_344
    assert eval_pass_flops(stretch, 4, 2) == 261_993_005_056


THETA = np.linspace(0, np.pi, 180, endpoint=False).astype(np.float32)


@pytest.mark.parametrize("batch, n, want_bytes, want_flops", [
    (20, 128, 3_963_920, 213_071_000),   # A: serve, (20,128,128) x 180 -> 184
    (32, 184, 8_576_528, 663_503_360),   # C: init batch, (32,184,184) x 180 -> 184
    (25, 184, 6_701_200, 518_362_000),   # C: fidelity chunk, (25,184,184) x 180 -> 184
])
def test_joseph_counts_reproduce_perf_md_rows(batch, n, want_bytes, want_flops):
    taps = joseph_taps_per_image(THETA, n, 184)
    assert joseph_cost(batch, n, 180, 184, taps) == (want_bytes, want_flops)


@pytest.mark.parametrize("algorithms, p, want", [
    (["sirt", "tv", "fbp", "gridrec"], 184, (91, 91)),  # section 6: 91 C and 91 D per init batch
    (["gridrec"], 728, (0, 2)),                          # the gridrec and mask channels on D
    (["gridrec"], 184, (0, 0)),                          # pixel-driven below 512 bins
])
def test_init_applications(algorithms, p, want):
    assert init_applications(algorithms, p) == want


def test_joseph_bound_is_the_sum_of_the_applications():
    taps = joseph_taps_per_image(THETA, 128, 184) / 180
    one = bound_seconds(*joseph_cost(20, 128, 20, 184, taps * 20))
    assert joseph_bound([(7, 20, 128, 20, 184)], THETA) == pytest.approx(7 * one, rel=1e-12)
    assert joseph_bound([(3, 20, 128, 20, 184), (4, 20, 128, 20, 184)], THETA) == pytest.approx(
        7 * one, rel=1e-12)


def test_roofline_share_follows_the_work_not_the_launches():
    """The share reads the same however the traced device time is cut into launches."""
    from types import SimpleNamespace

    import torch

    from gpubench.metrics._common import joseph_roofline

    uses = {"joseph_fwd_static": [(12, 20, 128, 20, 184)], "joseph_adj_static": []}
    loop = SimpleNamespace(theta=THETA, joseph_uses=lambda units: uses if units == 3 else {})
    bound = joseph_bound(uses["joseph_fwd_static"], THETA)
    name = "void joseph_fwd_static_kernel<4>(float const*)"
    reads = []
    for launches in ([1e-3] * 12, [2e-3] * 6, [12e-3]):
        trace = {"units": 3, "launches": {name: launches, "other": [5.0]}}
        reads.append(joseph_roofline(SimpleNamespace(trace=trace, loop=loop,
                                                     device=torch.device("cpu"))))
    assert reads == pytest.approx([100 * bound / 12e-3] * 3)
