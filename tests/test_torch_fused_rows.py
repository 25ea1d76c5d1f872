"""Kernel A's rows on the forward kernel (``csrc/joseph_fwd_static.cu``),
mirrored in numpy.

``radon_fused`` hands the forward kernel the kernel rows of the call's
angles as the caller selected them (``Server.project``: an ``index_select``
of the full table's rows).  Each block finds its own rows: it counts the
x-major rows, takes group ``blockIdx.y`` of the x-major rows and then of the
y-major ones, finds the positions of that group's rows by a prefix count
(warp ballots over chunks of the block's threads), and writes output angle
``a`` from the row at position ``a``.  These tests mirror that search and
the kernel's row loop (lines split into two halves, added into zeros)
and hold them against the plain version, on the serve and train shapes'
angle sets, on the stretch recipe's (its 512^2 recon onto 728 bins: 20 of
its 360 angles, and all 360 for the final evaluation) and on ragged ones
(one axis only, fewer rows than a block, duplicate angles, indices all past
20).  The kernels run only on the card
(``tests/test_torch_cuda.py``).
"""

import os

import numpy as np
import pytest
import torch

from ct_pvae_tpu_torch.ops import joseph_radon as jr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMPTY_ROW = np.array([1.0, 0.0, -1e9, 0.0], np.float32)  # the kernel's row for an empty slot


def _paper_theta() -> np.ndarray:
    theta, _ = np.load(os.path.join(REPO, "dataset_foam", "dataset_parameters.npy"), allow_pickle=True)
    return np.asarray(theta, np.float32)


STRETCH_THETA = np.linspace(0, np.pi, 360, endpoint=False).astype(np.float32)


def _angle_sets():
    """Angle index sets of a call, by name: the serve and train shapes and
    the ragged cases of the paper recipe (theta of dataset_foam), then the
    stretch recipe's train and final-evaluation sets (``STRETCH_THETA``)."""
    theta = _paper_theta()
    rng = np.random.default_rng(9)
    flags = jr.angle_table_fused(theta, 128, 128, 184)[:, 4] > 0.5
    x_major = np.flatnonzero(~flags)
    return theta, {
        "serve": np.arange(180),
        "train": rng.permutation(180)[:20],
        "past 20": rng.choice(np.arange(20, 180), 20, replace=False),
        "one axis": rng.choice(x_major, 20, replace=False),
        "few rows": rng.permutation(180)[:3],
        "duplicates": np.array([5, 5, 170, 90, 5, 170, 33]),
        "stretch train": np.random.default_rng(10).permutation(360)[:20],
        "stretch eval": np.arange(360),
    }


def _call_rows(case, n=None, n_det=None):
    """The (A, 8) kernel rows of a call: the case's angles of its recipe's
    table, at the recipe's recon geometry (128^2 onto 184 bins; stretch:
    512^2 onto 728) unless ``n`` and ``n_det`` say otherwise."""
    theta, sets = _angle_sets()
    if case.startswith("stretch"):
        theta, geometry = STRETCH_THETA, (512, 728)
    else:
        geometry = (128, 184)
    n, n_det = (n, n_det) if n is not None else geometry
    return jr.kernel_rows(jr.angle_table_fused(theta, n, n, n_det))[sets[case]]


def _block_rows(flags, block_y, per_block, threads):
    """Kernel C's search for block ``block_y``'s rows: (is_y, positions)."""
    a = len(flags)
    nx = int((~flags).sum())  # __syncthreads_count over chunks of the block
    groups_x = -(-nx // per_block)
    is_y = block_y >= groups_x
    first = (block_y - groups_x if is_y else block_y) * per_block
    live = min(per_block, (a - nx if is_y else nx) - first)
    if live <= 0:
        return is_y, []
    angle = [None] * live
    before, c0 = 0, 0
    while c0 < a and before < first + live:
        q = c0 + np.arange(threads)
        mine = (q < a) & (flags[np.minimum(q, a - 1)] == is_y)
        warps = mine.reshape(-1, 32)
        warp_rows = warps.sum(1)
        lane_rank = np.cumsum(warps, 1) - warps  # popc of the ballot below the lane
        rank = before + ((np.cumsum(warp_rows) - warp_rows)[:, None] + lane_rank).reshape(-1)
        for qq, rr in zip(q[mine], rank[mine]):
            if first <= rr < first + live:
                angle[rr - first] = int(qq)
        before += int(warp_rows.sum())
        c0 += threads
    assert None not in angle
    return is_y, angle


def _groups(flags, per_block, threads):
    """Every block row of the grid: ceil(A / per_block) + 1 of them."""
    return [_block_rows(flags, y, per_block, threads) for y in range(-(-len(flags) // per_block) + 1)]


@pytest.mark.parametrize("per_block, threads", [(8, 64), (16, 512), (16, 768)])
@pytest.mark.parametrize("case", ["serve", "train", "past 20", "one axis", "few rows", "duplicates",
                                  "stretch train", "stretch eval"])
def test_each_call_position_lands_in_exactly_one_group(case, per_block, threads):
    rows = _call_rows(case)
    flags = rows[:, 4] > 0.5
    groups = _groups(flags, per_block, threads)
    seen = [q for _, angle in groups for q in angle]
    assert sorted(seen) == list(range(len(rows)))  # every position once, as its own output angle
    for is_y, angle in groups:
        assert len(angle) <= per_block and (flags[angle] == is_y).all()  # one major axis a block
        assert angle == sorted(angle)  # in call order
    # only the last group of each axis is short, and the grid's rows (one
    # more than the rows need in groups) hold both axes' groups
    lengths = [[len(a) for y, a in groups if y == axis and a] for axis in (False, True)]
    for axis, ls in zip((False, True), lengths):
        assert all(x == per_block for x in ls[:-1])
        assert len(ls) == -(-int((flags == axis).sum()) // per_block)


def _forward_by_groups(image, rows, n_det, per_block, threads=256):
    """Kernel C's row loop in numpy: per block group, each ray's taps over the
    lines of each half (pos as ``joseph_pos`` rounds it, taps off the image
    reading the zeros around each staged line), each half's sum times the
    weight added to zero; output angle from the row's position.  Positions
    never written stay NaN."""
    b, n, _ = image.shape
    out = np.full((b, len(rows), n_det), np.nan, np.float32)
    parts = 2
    span = ((n + 1) // 2 + 3) // 4 * 4
    t = np.arange(n_det, dtype=np.float32)[None, :]   # (1, T)
    for is_y, angle in _groups(rows[:, 4] > 0.5, per_block, threads):
        if not angle:
            continue
        lo = np.concatenate([rows[angle, :4], np.tile(EMPTY_ROW, (per_block - len(angle), 1))])
        src = image.transpose(0, 2, 1) if is_y else image
        # staged lines: two zeros on each side
        lines = np.zeros((b, n, n + 4), np.float32)
        lines[:, :, 2:n + 2] = src
        part_sums = []
        for p in range(parts):
            acc = np.zeros((per_block, n_det, b), np.float32)
            for r in range(p * span, min(n, (p + 1) * span)):
                pos = _mul_add(lo[:, 1:2], np.float32(r), _mul_add(lo[:, 0:1], t, lo[:, 2:3]))  # (R, T)
                y0f = np.floor(pos)
                y0 = np.clip(y0f, -2, n).astype(np.int64)
                h0 = np.maximum(np.float32(0), np.float32(1) - np.abs(y0f - pos))[..., None]
                h1 = np.maximum(np.float32(0), np.float32(1) - np.abs(y0f + np.float32(1) - pos))[..., None]
                line = lines[:, r].T                          # (n + 4, B)
                acc = _fma(line[y0 + 3], h1, _fma(line[y0 + 2], h0, acc))
            part_sums.append(acc)
        w = lo[: len(angle), 3:4, None]
        total = np.float32(0) + part_sums[0][: len(angle)] * w + part_sums[1][: len(angle)] * w
        out[:, angle] = total.transpose(2, 0, 1)
    return out


def _fma(a, b, c):
    """float32 fused multiply-add (the float32 product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(
        np.float32)


def _mul_add(a, b, c):
    """float32 a * b + c, the product rounded first: ``joseph_pos``'s arithmetic."""
    return np.asarray(a, np.float32) * np.asarray(b, np.float32) + np.asarray(c, np.float32)


@pytest.mark.parametrize("per_block", [8, 16])
@pytest.mark.parametrize("case", ["train", "one axis", "duplicates", "stretch train"])
def test_row_loop_on_grouped_rows_matches_the_plain_version(case, per_block):
    """The rows of a subset, grouped on the device, reproduce radon_fused_plain
    on a small image (17^2 onto 26 bins: the halves of the lines end off a
    multiple of 4, and two halves of floor(17 / 2) lines rounded up to 4
    would miss the last line), and on the stretch recipe's train call at its
    own geometry (one 512^2 image onto 728 bins: the image narrower than the
    detector), in every output position, and the empty rows add nothing."""
    n, n_det, batch = (512, 728, 1) if case.startswith("stretch") else (17, 26, 3)
    rows = _call_rows(case, n, n_det)
    image = np.random.default_rng(1).uniform(0, 1, (batch, n, n)).astype(np.float32)
    out = _forward_by_groups(image, rows, n_det, per_block)
    ref = jr.radon_fused_plain(torch.from_numpy(image), torch.from_numpy(rows[:, :5].copy()), n_det).numpy()
    assert not np.isnan(out).any()
    # the same taps, another summation order
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_empty_row_taps_fall_off_the_image():
    """The kernel's row for an empty slot puts both taps of every ray and line
    on the zeros left of the staged line (y0 clamped to -2), at weight 0."""
    t = np.arange(1536, dtype=np.float32)[:, None]
    r = np.arange(1536, dtype=np.float32)[None, :]
    pos = _mul_add(EMPTY_ROW[1], r, _mul_add(EMPTY_ROW[0], t, EMPTY_ROW[2]))
    assert (np.floor(pos) <= -2).all() and EMPTY_ROW[3] == 0


def test_rows_and_table_give_the_same_projection_and_gradient():
    """On the CPU, radon_fused on (A, 8) kernel rows, as Server.project
    passes them, is radon_fused on the (A, 5) table, forward and backward."""
    theta, sets = _angle_sets()
    table = jr.angle_table_fused(theta, 24, 24, 34)
    rows = torch.from_numpy(jr.kernel_rows(table)).index_select(0, torch.as_tensor(sets["train"]))
    tab = torch.from_numpy(table[sets["train"]])
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 24, 24)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(2, 20, 34)).astype(np.float32))
    grads = []
    for t_or_rows in (tab, rows):
        xg = x.clone().requires_grad_()
        out = jr.radon_fused(xg, t_or_rows, 34)
        (out * w).sum().backward()
        grads.append((out.detach(), xg.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])
    assert torch.equal(jr.radon_fused_adjoint(w, rows, 24), jr.radon_fused_adjoint(w, tab, 24))


def test_server_projects_through_the_full_tables_rows():
    """Server keeps the kernel rows of the full recon table and selects a
    step's angles from them; on the CPU the projection is the plain version
    on the table's rows."""
    from ct_pvae_tpu_torch.config import Config
    from ct_pvae_tpu_torch.vi.serve import Server

    theta = np.linspace(0, np.pi, 12, endpoint=False).astype(np.float32)
    sinos = np.random.default_rng(3).uniform(0, 1, (4, 12, 64)).astype(np.float32)
    cfg = Config(batch_size=2, truncate_dataset=4, cheap_init=True, real_data=True,
                 algorithms=["fbp"], num_blocks=2, num_feature_maps=4, save_path=None)
    srv = Server(cfg, sinos, theta, torch.device("cpu"), kernel_route=True)
    assert srv.joseph and srv.rows.shape == (12, 8)
    np.testing.assert_array_equal(
        srv.rows.numpy(), jr.kernel_rows(jr.angle_table_fused(theta, srv.x_size, srv.x_size, 64)))
    recon = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (2, srv.x_size, srv.x_size))
                             .astype(np.float32))
    idx = torch.as_tensor([11, 3, 7])
    want = jr.radon_fused_plain(recon, srv.rows[idx, :5], 64)
    assert torch.equal(srv.project(recon, idx), want)


def test_row_kernel_wrappers_take_cuda_tensors_only():
    from ct_pvae_tpu_torch.ops import _cuda

    rows = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.joseph_fwd_static(torch.zeros((2, 8, 8)), rows, 12)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.joseph_adj_static(torch.zeros((2, 4, 12)), rows, 8)


def test_floor_hats_are_the_hat_expression_bitwise():
    """``joseph_floor_hats`` (csrc/joseph_tap.cuh), the forward's two hats
    without fabsf and fmaxf, equals ``joseph_hat`` at y0 = floor(pos) and
    y0 + 1 bitwise for |pos| < 2^23: positions of the serve and train
    shapes' rays, integers and their float neighbours, and the range's ends."""
    rng = np.random.default_rng(5)
    ints = np.arange(-300, 301, dtype=np.float32)
    pos = np.concatenate([
        rng.uniform(-300, 300, 200_000).astype(np.float32),
        ints, np.nextafter(ints, np.float32(-np.inf)), np.nextafter(ints, np.float32(np.inf)),
        rng.uniform(-2 ** 22, 2 ** 22, 50_000).astype(np.float32),
        np.float32([2 ** 23 - 0.5, -(2 ** 23) + 0.5, 1e-30, -1e-30, 0.0, -0.0]),
    ])
    one, zero = np.float32(1), np.float32(0)
    y0 = np.floor(pos)
    h0 = one - (pos - y0)
    h1 = one - ((y0 + one) - pos)
    np.testing.assert_array_equal(h0, np.maximum(zero, one - np.abs(y0 - pos)))
    np.testing.assert_array_equal(h1, np.maximum(zero, one - np.abs((y0 + one) - pos)))
