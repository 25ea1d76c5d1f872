"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the gather route on a CUDA tensor.

Marked ``cuda``: they skip without an NVIDIA GPU (and nvcc).  On a machine
with one: ``python -m pytest tests/test_torch_cuda.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

from ct_pvae_tpu_torch.config import Config
from ct_pvae_tpu_torch.ops import _cuda, conv_fused
from ct_pvae_tpu_torch.ops import joseph_radon as jr
from ct_pvae_tpu_torch.ops import radon
from ct_pvae_tpu_torch.scripts.probe_conv_fused import probe_inputs
from ct_pvae_tpu_torch.vi.serve import joseph_route

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the kernels have no CPU mode")
    return torch.device("cuda")


# The calls radon_fused sees: (n, n_det, angle indices of the call, batch).
# Serve: all 180 angles; train: 20 drawn; then 20 drawn past the first 20
# (output angles far below the full table's), 20 of one major axis (the
# other axis's groups empty), duplicate angles, batches 1 and 3, and an odd
# size whose lines split unevenly into parts (33 pixels onto 50 bins).
_THETA = np.linspace(0, np.pi, 180, endpoint=False).astype(np.float32)
_X_MAJOR = np.flatnonzero(np.abs(np.cos(_THETA)) >= np.abs(np.sin(_THETA)))
_CALLS = {
    "serve": (128, 184, np.arange(180), 20),
    "train": (128, 184, np.random.default_rng(1).permutation(180)[:20], 20),
    "past 20": (128, 184, np.random.default_rng(2).choice(np.arange(20, 180), 20, replace=False), 20),
    "one axis": (128, 184, np.random.default_rng(3).choice(_X_MAJOR, 20, replace=False), 20),
    "duplicates": (128, 184, np.array([5, 5, 170, 90, 5, 170, 33]), 3),
    "batch 1": (128, 184, np.random.default_rng(4).permutation(180)[:20], 1),
    "batch 3": (32, 48, np.random.default_rng(5).permutation(180)[:12], 3),
    "odd size": (33, 50, np.random.default_rng(6).permutation(180)[:20], 5),
}


def _call_rows(case, cuda):
    """(rows, table, n, n_det, batch): the call's kernel rows selected on the
    card from the full table's rows, as Server.project selects them, and the
    same angles' (A, 5) table for the plain version."""
    n, n_det, idx, batch = _CALLS[case]
    full = jr.angle_table_fused(_THETA, n, n, n_det)
    sel = torch.as_tensor(idx, device=cuda)
    rows = torch.as_tensor(jr.kernel_rows(full), device=cuda).index_select(0, sel)
    return rows, torch.as_tensor(full[idx], device=cuda), n, n_det, batch


# the tests' first cases, (n, n_det, n_angles, batch) with sorted angles drawn
# by a seeded generator, then the calls above
_FIRST_FWD = [(32, 48, 12, 3), (128, 184, 180, 20), (128, 184, 20, 20)]
_FIRST_ADJ = [(32, 48, 12, 3), (128, 184, 20, 20), (184, 184, 180, 32)]


def _ids(cases):
    return ["-".join(map(str, c)) if isinstance(c, tuple) else c for c in cases]


@pytest.mark.parametrize("case", [*_FIRST_FWD, *_CALLS], ids=_ids([*_FIRST_FWD, *_CALLS]))
def test_joseph_kernel_matches_plain(cuda, case):
    """Kernel A (radon_fused on the forward kernel) against its plain version
    and its first design: on the kernel rows of a sorted angle subset, and on
    the kernel rows of the call's angles as Server.project selects them."""
    if isinstance(case, tuple):
        n, n_det, n_angles, batch = case
        rng = np.random.default_rng(n_angles)
        idx = np.sort(rng.choice(180, n_angles, replace=False))
        table = torch.as_tensor(jr.angle_table_fused(np.linspace(0, np.pi, 180, endpoint=False),
                                                     n, n, n_det)[idx], device=cuda)
        rows = _kernel_rows(table)
    else:
        rows, table, n, n_det, batch = _call_rows(case, cuda)
        rng = np.random.default_rng(len(case))
    img = torch.as_tensor(rng.uniform(0, 1, (batch, n, n)).astype(np.float32), device=cuda)
    before = jr.LAUNCHES["joseph_fwd"]
    out = jr.radon_fused(img, rows, n_det)
    torch.cuda.synchronize()
    assert jr.LAUNCHES["joseph_fwd"] == before + 1
    ref = jr.radon_fused_plain(img, table, n_det)
    # same taps, another summation order
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    torch.testing.assert_close(out, _cuda.joseph_fwd(img, table, n_det), rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(jr.radon_fused(img, rows, n_det), out)  # deterministic


def test_joseph_kernel_rejects_non_contiguous(cuda):
    rows = jr.static_rows((0.0,), 8, 12, cuda)
    img = torch.zeros((2, 8, 8), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        jr.radon_fused(img, rows, 12)


def _kernel_rows(table):
    """The (A, 8) kernel rows of an (A, 5) table on the card: what
    radon_fused takes on a CUDA tensor."""
    return torch.as_tensor(jr.kernel_rows(table.cpu().numpy()), device=table.device)


def _table(n, n_det, n_angles, seed, cuda):
    rng = np.random.default_rng(seed)
    theta = np.linspace(0, np.pi, 180, endpoint=False)
    idx = np.sort(rng.choice(180, n_angles, replace=False))
    return torch.as_tensor(jr.angle_table_fused(theta, n, n, n_det)[idx], device=cuda)


@pytest.mark.parametrize("case", [*_FIRST_ADJ, *_CALLS], ids=_ids([*_FIRST_ADJ, *_CALLS]))
def test_adjoint_kernel_matches_plain_and_is_the_transpose(cuda, case):
    """Kernel B (radon_fused_adjoint on the adjoint kernel) against its plain
    version and its first design (also on a full 180-angle table), and
    <A x, g> = <x, A^T g> between kernels A and B."""
    first = isinstance(case, tuple)
    if first:
        n, n_det, n_angles, batch = case
        rng = np.random.default_rng(n)
        table = _table(n, n_det, n_angles, n, cuda)
        rows = _kernel_rows(table)
    else:
        rows, table, n, n_det, batch = _call_rows(case, cuda)
        rng = np.random.default_rng(n + batch)
    g = torch.as_tensor(rng.normal(size=(batch, rows.shape[0], n_det)).astype(np.float32), device=cuda)
    x = torch.as_tensor(rng.uniform(0, 1, (batch, n, n)).astype(np.float32), device=cuda)
    before = jr.LAUNCHES["joseph_adj"]
    out = jr.radon_fused_adjoint(g, rows, n)
    torch.cuda.synchronize()
    assert jr.LAUNCHES["joseph_adj"] == before + 1
    ref = jr.radon_fused_adjoint_plain(g, table, n)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    torch.testing.assert_close(out, _cuda.joseph_adj(g, table, n), rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    ax = jr.radon_fused(x, rows, n_det).double()
    if first:
        lhs = (ax * g.double()).sum()
        rhs = (x.double() * out.double()).sum()
        assert abs(float(lhs - rhs)) <= 1e-5 * abs(float(lhs))
    # with g >= 0 no cancellation in the two sums hides their rounding (on
    # signed g, <Ax, g> can come out 30 times below its terms' size): the
    # kernels' taps are bitwise the same, so the sums agree to 1e-6
    g_pos = g.abs()
    lhs = (ax * g_pos.double()).sum()
    rhs = (x.double() * jr.radon_fused_adjoint(g_pos, rows, n).double()).sum()
    assert abs(float(lhs - rhs)) <= 1e-6 * abs(float(lhs))


# calls that the kernels' launch-shape rules route to each instantiation:
# (case of _CALLS or (n, n_det, angles, batch) on the full table, forward's
# rays a thread, adjoint's images a thread)
_SHAPES = {
    "serve": ("serve", 2, 8),                   # 180 rows at batch 20
    "train": ("train", 1, 8),                   # fewer than 64 rows
    "batch 3": ((128, 184, 180, 3), 1, 4),      # batch <= 4
    "batch 32": ((128, 184, 180, 32), 2, 16),   # batch above 24
}


@pytest.mark.parametrize("case", list(_SHAPES))
def test_every_launch_shape_agrees(cuda, case):
    """The forward at each launch shape (1 or 2 rows a thread) and the
    adjoint at each batch chunk (4, 8, 16) against the plain versions, each
    reached by a call whose size the kernels' rules route to it."""
    call = _SHAPES[case][0]
    if isinstance(call, str):
        rows, table, n, n_det, batch = _call_rows(call, cuda)
    else:
        n, n_det, n_angles, batch = call
        table = torch.as_tensor(jr.angle_table_fused(_THETA[:n_angles], n, n, n_det), device=cuda)
        rows = _kernel_rows(table)
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.uniform(0, 1, (batch, n, n)).astype(np.float32), device=cuda)
    g = torch.as_tensor(rng.normal(size=(batch, rows.shape[0], n_det)).astype(np.float32), device=cuda)
    _close(_cuda.joseph_fwd_static(x, rows, n_det), jr.radon_fused_plain(x, table, n_det))
    _close(_cuda.joseph_adj_static(g, rows, n), jr.radon_fused_adjoint_plain(g, table, n))


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
    (jr.radon_fused(img, _kernel_rows(table), 184) * w).sum().backward()
    torch.cuda.synchronize()
    assert jr.LAUNCHES["joseph_adj"] == before["joseph_adj"] + 1
    torch.testing.assert_close(img.grad, jr.radon_fused_adjoint_plain(w, table, 128), rtol=1e-5,
                               atol=1e-5 * float(img.grad.abs().max()))


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("batch", [32, 8, 4, 1])
def test_static_kernels_match_plain_and_are_transposes(cuda, batch):
    """Kernels C and D (csrc/joseph_fwd_static.cu, csrc/joseph_adj_static.cu)
    at the init stack's shape, (B, 184, 184) x 180 angles, with a full batch
    chunk and ragged ones (8 and 4 end the init stacks of 1000 and 100
    scans): against their plain versions, <Cx, g> = <x, Dg>, and
    radon_static's backward launching D."""
    theta = tuple(float(t) for t in np.linspace(0, np.pi, 180, endpoint=False).astype(np.float32))
    rng = np.random.default_rng(batch)
    x = torch.as_tensor(rng.uniform(0, 1, (batch, 184, 184)).astype(np.float32), device=cuda)
    g = torch.as_tensor(rng.uniform(0, 1, (batch, 180, 184)).astype(np.float32), device=cuda)
    table = jr.static_table(theta, 184, 184, cuda)
    before = dict(jr.LAUNCHES)
    fwd = jr.radon_static(x, theta, 184)
    adj = jr.backproject_static(g, theta, 184, 184)
    torch.cuda.synchronize()
    assert jr.LAUNCHES["joseph_fwd_static"] == before["joseph_fwd_static"] + 1
    assert jr.LAUNCHES["joseph_adj_static"] == before["joseph_adj_static"] + 1
    _close(fwd, jr.radon_fused_plain(x, table, 184))
    _close(adj, jr.radon_fused_adjoint_plain(g, table, 184))
    lhs = float((fwd.double() * g.double()).sum())
    rhs = float((x.double() * adj.double()).sum())
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs)
    xg = x.clone().requires_grad_()
    (jr.radon_static(xg, theta, 184) * g).sum().backward()
    torch.cuda.synchronize()
    assert jr.LAUNCHES["joseph_adj_static"] == before["joseph_adj_static"] + 2
    assert torch.equal(xg.grad, adj)


def _at_offset(x, offset):
    """A contiguous copy of x whose storage starts ``offset`` floats into its
    allocation (not on 16 bytes for offset 1)."""
    flat = torch.zeros(x.numel() + offset, dtype=x.dtype, device=x.device)
    return flat[offset:].view_as(x).copy_(x)


@pytest.mark.parametrize("batch, n, n_angles, n_det, offset", [(5, 37, 53, 50, 0), (6, 32, 20, 48, 1)])
def test_static_kernels_at_odd_shapes_and_offsets(cuda, batch, n, n_angles, n_det, offset):
    """C and D where they load element by element: n and n_det not multiples
    of 4 (and batch 5, D's chunk of 8 cut short), or image and sinogram that
    do not start on 16 bytes; against their plain versions and as transposes."""
    theta = tuple(float(t) for t in np.linspace(0, np.pi, n_angles, endpoint=False))
    rng = np.random.default_rng(n)
    x = _at_offset(torch.as_tensor(rng.uniform(0, 1, (batch, n, n)).astype(np.float32), device=cuda), offset)
    g = _at_offset(torch.as_tensor(rng.normal(size=(batch, n_angles, n_det)).astype(np.float32),
                                   device=cuda), offset)
    assert (x.data_ptr() % 16 != 0) == (offset == 1)
    table = jr.static_table(theta, n, n_det, cuda)
    fwd = jr.radon_static(x, theta, n_det)
    adj = jr.backproject_static(g, theta, n, n)
    _close(fwd, jr.radon_fused_plain(x, table, n_det))
    _close(adj, jr.radon_fused_adjoint_plain(g, table, n))
    lhs = float((fwd.double() * g.double()).sum())
    rhs = float((x.double() * adj.double()).sum())
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs)


def test_adjoint_kernels_above_1024_angles(cuda):
    """B and D (and C) at 1200 angles: the kernels stage their tables in
    chunks, so there is no cap on the angles."""
    n, n_det, batch = 32, 48, 3
    theta = tuple(float(t) for t in np.linspace(0, np.pi, 1200, endpoint=False))
    rng = np.random.default_rng(1200)
    table = jr.static_table(theta, n, n_det, cuda)
    g = torch.as_tensor(rng.normal(size=(batch, 1200, n_det)).astype(np.float32), device=cuda)
    x = torch.as_tensor(rng.uniform(0, 1, (batch, n, n)).astype(np.float32), device=cuda)
    ref = jr.radon_fused_adjoint_plain(g, table, n)
    _close(jr.radon_fused_adjoint(g, jr.static_rows(theta, n, n_det, cuda), n), ref)
    _close(jr.backproject_static(g, theta, n, n), ref)
    _close(jr.radon_static(x, theta, n_det), jr.radon_fused_plain(x, table, n_det))


def test_static_kernels_reject_what_they_do_not_take(cuda):
    theta = (0.0, 1.0)
    rows = jr.static_rows(theta, 8, 12, cuda)
    x = torch.zeros((2, 8, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        _cuda.joseph_fwd_static(x.transpose(1, 2), rows, 12)
    big = _cuda.FWD_STATIC_MAX_N + 1
    with pytest.raises(ValueError, match="pixels"):
        _cuda.joseph_fwd_static(torch.zeros((1, big, big), device=cuda), rows, 12)
    with pytest.raises(ValueError, match="16-byte"):
        _cuda.joseph_fwd_static(x, torch.zeros(17, device=cuda)[1:].view(2, 8), 12)
    with pytest.raises(ValueError, match="kernel rows"):
        _cuda.joseph_adj_static(torch.zeros((2, 3, 12), device=cuda), rows, 8)
    with pytest.raises(ValueError, match="kernel rows"):  # radon_fused takes no (A, 5) table on the card
        jr.radon_fused(x, jr.static_table(theta, 8, 12, cuda), 12)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.joseph_adj_static(torch.zeros((2, 2, 12)), rows, 8)


@pytest.mark.parametrize("b, hw, c, f", [(10, 128, 40, 40), (3, 37, 11, 70)])
def test_conv_fused_kernel_matches_plain(cuda, b, hw, c, f):
    """Kernel E at the probe's default shape and at a ragged one (tiles cut
    at the edges, two blocks of output pairs, a channel chunk cut short)."""
    x, kern, bias = probe_inputs(b, hw, c, f, 3, cuda)
    x = x[:, :, : hw - 2].contiguous()  # W = hw - 2: not a multiple of the column tile
    before = conv_fused.LAUNCHES["conv_fused_maxout"]
    out = conv_fused.conv3x3_periodic_maxout(x, kern, bias)
    torch.cuda.synchronize()
    assert conv_fused.LAUNCHES["conv_fused_maxout"] == before + 1
    ref = conv_fused.conv3x3_periodic_maxout_plain(x, kern, bias)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    with pytest.raises(RuntimeError, match="forward only"):
        conv_fused.conv3x3_periodic_maxout(x.requires_grad_(), kern, bias)


@pytest.mark.parametrize("b, h, w, c, f, offset", [
    (3, 37, 35, 11, 70, 0),   # C 11: no 16-byte rows; F 70: two pair groups, the second padded
    (1, 5, 5, 11, 70, 0),     # batch 1, one tile hanging past every edge
    (1, 5, 5, 40, 40, 0),
    (2, 16, 16, 40, 40, 1),   # a view one float into its storage: 4-byte copies
    (2, 20, 19, 80, 12, 0),   # C 80: ten channel chunks, ten stages an item
])
def test_conv_fused_kernel_at_odd_shapes_and_offsets(cuda, b, h, w, c, f, offset):
    """Kernel E (and its first design, the yardstick) against the plain
    version where its copies, tiles or stages take another path."""
    x, kern, bias = probe_inputs(b, max(h, w), c, f, 3, cuda)
    x = _at_offset(x[:, :h, :w], offset)
    assert (x.data_ptr() % 16 != 0) == (offset == 1)
    ref = conv_fused.conv3x3_periodic_maxout_plain(x, kern, bias)
    tol = dict(rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    before = conv_fused.LAUNCHES["conv_fused_maxout"]
    torch.testing.assert_close(conv_fused.conv3x3_periodic_maxout(x, kern, bias), ref, **tol)
    assert conv_fused.LAUNCHES["conv_fused_maxout"] == before + 1
    torch.testing.assert_close(_cuda.conv_fused_maxout(x, kern, bias), ref, **tol)
    assert conv_fused.LAUNCHES["conv_fused_maxout"] == before + 1  # the yardstick is not counted


def test_conv_fused_kernel_rejects_what_it_does_not_take(cuda):
    x, kern, bias = probe_inputs(1, 8, 4, 3, 3, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        _cuda.conv_fused_mma(x.transpose(1, 2), kern, bias)
    with pytest.raises(ValueError, match="bad shapes"):
        _cuda.conv_fused_mma(x, kern[:, :, :3].contiguous(), bias)
    with pytest.raises(TypeError, match="float32"):
        _cuda.conv_fused_mma(x.double(), kern, bias)


def test_gather_route_on_a_cuda_tensor(cuda):
    """Below 64 detector pixels, or with use_pallas off, the card takes the
    gather projector: the same numbers as the CPU's, and the same gradient."""
    assert not joseph_route(Config(), 63, cuda) and not joseph_route(Config(use_pallas=False), 184, cuda)
    assert joseph_route(Config(), 64, cuda)
    rng = np.random.default_rng(3)
    img = torch.as_tensor(rng.uniform(0, 1, (20, 128, 128)).astype(np.float32))
    theta = torch.as_tensor(np.sort(rng.uniform(0, np.pi, 20)).astype(np.float32))
    x = img.to(cuda).requires_grad_()
    calls, launches = radon.CALLS["radon"], dict(jr.LAUNCHES)
    out = radon.radon(x, theta.to(cuda), pad=True, n_det=184)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert radon.CALLS["radon"] == calls + 1 and jr.LAUNCHES == launches
    x_cpu = img.clone().requires_grad_()
    ref = radon.radon(x_cpu, theta, pad=True, n_det=184)
    ref.square().sum().backward()
    ref = ref.detach()
    torch.testing.assert_close(out.detach().cpu(), ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    torch.testing.assert_close(x.grad.cpu(), x_cpu.grad, rtol=1e-5,
                               atol=1e-5 * float(x_cpu.grad.abs().max()))


# The stretch recipe (configs/foam_stretch.yaml): 512^2 foams padded to
# 728 pixels, 360 angles, a 728-bin detector.
_STRETCH_THETA = np.linspace(0, np.pi, 360, endpoint=False).astype(np.float32)


@pytest.mark.parametrize("batch", [16, 64, 36])
def test_radon_fast_takes_kernel_c_at_the_stretch_shape(cuda, batch):
    """make-data's projection on the card: radon_fast pads the 512^2 images
    to 728 and launches kernel C once per chunk (a full chunk of 64, the 16
    of the smoke run's dataset, a ragged 36), never the gather projector;
    against C's plain version, and <Cx, g> = <x, Dg> there."""
    from ct_pvae_tpu_torch.ops.radon import pad_phantom, radon_fast

    rng = np.random.default_rng(batch)
    img = torch.as_tensor(rng.uniform(0, 1, (batch, 512, 512)).astype(np.float32), device=cuda)
    theta_f = tuple(float(t) for t in _STRETCH_THETA)
    calls, before = radon.CALLS["radon"], dict(jr.LAUNCHES)
    out = radon_fast(img, _STRETCH_THETA, pad=True)
    torch.cuda.synchronize()
    assert out.shape == (batch, 360, 728)
    assert jr.LAUNCHES["joseph_fwd_static"] == before["joseph_fwd_static"] + 1
    assert radon.CALLS["radon"] == calls
    padded = pad_phantom(img, 728)
    _close(out, jr.radon_fused_plain(padded, jr.static_table(theta_f, 728, 728, cuda), 728))
    g = torch.as_tensor(rng.uniform(0, 1, (batch, 360, 728)).astype(np.float32), device=cuda)
    lhs = float((out.double() * g.double()).sum())
    rhs = float((padded.double() * jr.backproject_static(g, theta_f, 728, 728).double()).sum())
    assert abs(lhs - rhs) <= 1e-6 * abs(lhs)


def test_radon_fast_takes_kernel_c_for_the_toy_objects(cuda):
    """The toy make-data projection (2 x 2 images, 2 angles, no padding) on
    kernel C, as the JAX package takes its Pallas kernel on a TPU: the
    analytic column and flipped row sums."""
    from ct_pvae_tpu_torch.data.toy import generate_toy_images, toy_theta
    from ct_pvae_tpu_torch.ops.radon import radon_fast

    imgs = generate_toy_images(16)
    before = jr.LAUNCHES["joseph_fwd_static"]
    sinos = radon_fast(torch.as_tensor(imgs, device=cuda), toy_theta()).cpu().numpy()
    assert jr.LAUNCHES["joseph_fwd_static"] == before + 1
    np.testing.assert_allclose(sinos[:, 0], imgs.sum(axis=1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sinos[:, 1], imgs.sum(axis=2)[:, ::-1], rtol=0, atol=1e-6)


def test_fbp_past_512_detector_pixels_takes_kernel_d(cuda):
    """The stretch init stack's FBP (a 728-bin detector onto 728^2) on the
    card: kernel D once, no gather call, equal to the ramp filter and D's
    plain version; the gather backprojector stays the route below 512."""
    from ct_pvae_tpu_torch.ops.fbp import fbp, filter_sinogram

    rng = np.random.default_rng(728)
    theta = torch.as_tensor(_STRETCH_THETA, device=cuda)
    sino = torch.as_tensor(rng.uniform(0, 1, (2, 360, 728)).astype(np.float32), device=cuda)
    calls, before = radon.CALLS["radon"], dict(jr.LAUNCHES)
    out = fbp(sino, theta, 728, 728)
    torch.cuda.synchronize()
    assert jr.LAUNCHES["joseph_adj_static"] == before["joseph_adj_static"] + 1
    table = jr.static_table(tuple(float(t) for t in _STRETCH_THETA), 728, 728, cuda)
    want = jr.radon_fused_adjoint_plain(filter_sinogram(sino), table, 728) * (np.pi / (2 * 360))
    _close(out, want)
    small = fbp(sino[..., :184].contiguous(), theta, 184, 184)
    assert jr.LAUNCHES["joseph_adj_static"] == before["joseph_adj_static"] + 1
    assert small.shape == (2, 184, 184) and radon.CALLS["radon"] == calls


def test_make_data_on_the_card_gives_the_analytic_toy_sinograms(cuda, tmp_path):
    from ct_pvae_tpu_torch.data.sinogram import make_dataset

    before = jr.LAUNCHES["joseph_fwd_static"]
    images, sinos, theta = make_dataset("toy", 64, save_path=str(tmp_path / "dataset_toy"))
    assert jr.LAUNCHES["joseph_fwd_static"] == before + 1
    assert sinos.shape == (64, 2, 2) and (tmp_path / "toy_training.npy").exists()
    np.testing.assert_allclose(sinos[:, 0], images.sum(axis=1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sinos[:, 1], images.sum(axis=2)[:, ::-1], rtol=0, atol=1e-6)


def test_gridrec_on_the_card_matches_the_cpu(cuda):
    """Fourier gridrec at the stretch geometry (4 sinograms of 360 angles x
    728 bins onto 728^2; its matmul tables would pass 512 MB, so it
    scatters) on the card against the CPU: the same taps (sample positions
    from the CPU), another summation order and another FFT."""
    from ct_pvae_tpu_torch.ops.gridrec import gridrec

    rng = np.random.default_rng(11)
    sino = torch.as_tensor(rng.uniform(0, 1, (4, 360, 728)).astype(np.float32))
    theta = torch.as_tensor(_STRETCH_THETA)
    want = gridrec(sino, theta, 728, 728)
    got = gridrec(sino.to(cuda), theta.to(cuda), 728, 728).cpu()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


# The graphed train step: a small run on the Joseph route (64 bins), so that
# the captured step holds kernels A and B.
_STEP_THETA = np.linspace(0, np.pi, 24, endpoint=False).astype(np.float32)
_STEP_KW = dict(truncate_dataset=8, batch_size=4, num_sparse_angles=6, angles_per_iter=5,
                random_angles=True, num_samples=2, poisson_noise_multiplier=1e4, pnm_start=1e3,
                num_iter=8, algorithms=["fbp"], num_blocks=2, num_feature_maps=4,
                intermediate_layers=1, use_normal=True, train=True, seed=1)


def _step_trainer(cuda, save_path=None, **over):
    from ct_pvae_tpu_torch.vi.train import Trainer

    sinos = np.random.default_rng(0).uniform(0, 5, (8, 24, 64)).astype(np.float32)
    return Trainer(Config(save_path=save_path, **{**_STEP_KW, **over}), sinos, _STEP_THETA, cuda)


def _step_inputs(k):
    rng = np.random.default_rng(7)
    return ([rng.permutation(8)[:4] for _ in range(k)], [rng.permutation(24)[:5] for _ in range(k)])


def _params(tr):
    return torch.cat([s.param.detach().flatten() for s in tr.slots]).cpu()


@pytest.fixture
def deterministic(cuda):
    """cuDNN's deterministic algorithms (its default ones sum some backward
    convs with atomics, so two eager runs differ too)."""
    torch.backends.cudnn.deterministic = True
    yield cuda
    torch.backends.cudnn.deterministic = False


def _assert_steps_close(rows_a, rows_b, tr_a, tr_b):
    """Losses and params to 1e-6: the same arithmetic on the same draws."""
    torch.testing.assert_close(rows_a.cpu(), rows_b.cpu(), rtol=1e-6, atol=0)
    assert float((_params(tr_a) - _params(tr_b)).abs().max()) <= 1e-6


def test_graphed_step_matches_the_eager_step(deterministic):
    """Four replays of the captured train step against four eager steps from
    the same initial state, draws and indices: the same losses and params;
    the capture left the state as it was."""
    cuda = deterministic
    bidx, aidx = _step_inputs(4)
    graphed, eager = _step_trainer(cuda), _step_trainer(cuda)
    assert graphed.joseph and torch.equal(_params(graphed), _params(eager))
    before = _params(graphed)
    graphed.capture_step()
    assert torch.equal(_params(graphed), before) and graphed.step == 0
    rows_g = graphed.train_chunk(bidx, aidx)
    rows_e = torch.stack([eager.train_step(b, a) for b, a in zip(bidx, aidx)])
    assert graphed.step == eager.step == graphed.adam_count == 4
    _assert_steps_close(rows_g, rows_e, graphed, eager)


def test_launch_counters_move_with_replays(cuda):
    """The capture and its warm-up count no launch; each replay counts one A
    and one B, as an eager step does."""
    tr = _step_trainer(cuda)
    bidx, aidx = _step_inputs(4)
    before = dict(jr.LAUNCHES)
    tr.capture_step()
    assert jr.LAUNCHES == before
    tr.train_chunk(bidx, aidx)
    tr.train_chunk(bidx[:3], aidx[:3])
    assert jr.LAUNCHES["joseph_fwd"] == before["joseph_fwd"] + 7
    assert jr.LAUNCHES["joseph_adj"] == before["joseph_adj"] + 7
    tr.train_step(bidx[0], aidx[0])
    assert jr.LAUNCHES["joseph_adj"] == before["joseph_adj"] + 8


def test_beta_draws_are_restart_invariant_under_the_graph(deterministic, tmp_path):
    """Beta latents and output draw their gammas inside the captured step:
    four replays equal two eager steps, a checkpoint, a restored trainer
    and two replays of its own capture (the generator re-seeded by step)."""
    cuda = deterministic
    bidx, aidx = _step_inputs(4)
    whole = _step_trainer(cuda, use_normal=False)
    rows = whole.train_chunk(bidx, aidx)
    first = _step_trainer(cuda, str(tmp_path), use_normal=False)
    head = torch.stack([first.train_step(b, a) for b, a in zip(bidx[:2], aidx[:2])])
    first.checkpoint()
    resumed = _step_trainer(cuda, str(tmp_path), use_normal=False, restore=True, use_latest_ckpt=True)
    assert resumed.step == 2
    tail = resumed.train_chunk(bidx[2:], aidx[2:])
    _assert_steps_close(torch.cat([head, tail]), rows, resumed, whole)


# The image posterior (phase 11 of chip_smoke.py): 128^2 chains of the foam
# phantom, 20 of 180 angles onto 184 bins at a 1/20 dose, pnm 1e4.
def _image_posterior(cuda, chains=4):
    from ct_pvae_tpu_torch.mcmc import image_model as im

    rng = np.random.default_rng(11)
    n, n_det = 128, 184
    theta = np.sort(rng.choice(_THETA, 20, replace=False))
    c = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    xx, yy = np.meshgrid(c, c, indexing="ij")
    gt = (np.hypot(xx, yy) <= 0.8).astype(np.float32) * 0.5
    mask = np.full(20, 1.0 / 20, np.float32)
    proj = radon.radon(torch.as_tensor(gt[None]), torch.as_tensor(theta), pad=True, n_det=n_det)[0].numpy()
    meas = rng.poisson(np.clip(proj * mask[:, None], 0, None) * 1e4).astype(np.float32) / 1e4
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = im.init_chains_from_recon(gt + 0.05, chains, gen, device=cuda)
    return im, (meas, theta, mask, 1e4, n, n), x, gen


def test_image_log_prob_on_kernels_a_and_b_matches_plain(cuda):
    """The Joseph route's value and gradient at the chain batch on A and B
    against the same function on the plain version (the CPU), and within
    2e-2 of the gather route."""
    from ct_pvae_tpu_torch.mcmc.draws import value_and_grad

    im, args, x, _ = _image_posterior(cuda)
    before = dict(jr.LAUNCHES)
    v, g = value_and_grad(im.make_image_log_prob(*args, use_pallas=True, device=cuda), x)
    torch.cuda.synchronize()
    assert jr.LAUNCHES["joseph_fwd"] == before["joseph_fwd"] + 1
    assert jr.LAUNCHES["joseph_adj"] == before["joseph_adj"] + 1
    v_p, g_p = value_and_grad(im.make_image_log_prob(*args, use_pallas=True, device="cpu"), x.cpu())
    torch.testing.assert_close(v.cpu(), v_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(g.cpu(), g_p, rtol=0, atol=1e-4 * float(g_p.abs().max()))
    v_g = im.make_image_log_prob(*args, use_pallas=False, device=cuda)(x)
    assert float(((v - v_g).abs() / v_g.abs()).max()) < 2e-2


def test_nuts_chunk_on_the_card(cuda):
    """One warm-up chunk of NUTS on the gather route, its draws from a CUDA
    generator: finite states, a step that adapted, the chains moved."""
    from ct_pvae_tpu_torch.mcmc import NUTSConfig, nuts_sample

    im, args, x, gen = _image_posterior(cuda)
    lp = im.make_image_log_prob(*args, use_pallas=False, device=cuda)
    inv_mass = 1.0 / im.estimate_curvature_diag(x.mean(0), *args, gen=gen, use_pallas=False)
    cfg = NUTSConfig(num_results=4, num_burnin=8, step_size=1e-2, max_depth=5, adapt_mass=False)
    samples, diag = nuts_sample(lp, x, gen, cfg, inv_mass0=inv_mass)
    assert samples.shape == (4,) + tuple(x.shape) and samples.device.type == "cuda"
    assert torch.isfinite(samples).all() and float(diag["final_step_size"]) > 1e-5
    assert float((samples[-1] - x).abs().max()) > 1e-3
    assert 0.0 < float(diag["accept_rate"]) <= 1.0


@pytest.mark.parametrize("use_pallas", [True, False])
def test_curvature_on_both_routes_on_the_card(cuda, use_pallas):
    """estimate_curvature_diag through B (the Joseph route) or the gather
    projector's VJP, on the same probes: finite, positive, and the card's
    own CPU route within float32 rounding."""
    im, args, x, gen = _image_posterior(cuda)
    probes = torch.randint(0, 2, (16, x.shape[1]), generator=gen, device=cuda).float() * 2 - 1
    got = im.estimate_curvature_diag(x.mean(0), *args, use_pallas=use_pallas, probes=probes)
    want = im.estimate_curvature_diag(x.mean(0).cpu(), *args, use_pallas=use_pallas, probes=probes.cpu())
    assert torch.isfinite(got).all() and (got > 0).all()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-6 * float(want.abs().max()))


# The evaluation stage's new launch shapes and routes.


def test_fbp_with_per_example_angles_takes_the_gather_route(cuda):
    """merit's partial-sinogram row at the stretch detector: an (N, nsa)
    theta backprojects each sinogram through its own angles on the gather
    route (kernel D takes one angle set), equal to a loop over the examples."""
    from ct_pvae_tpu_torch.ops.fbp import fbp

    rng = np.random.default_rng(20)
    sino = torch.as_tensor(rng.uniform(0, 1, (3, 20, 728)).astype(np.float32), device=cuda)
    theta = torch.as_tensor(np.sort(rng.choice(_STRETCH_THETA, (3, 20)), axis=1), device=cuda)
    before = dict(jr.LAUNCHES)
    out = fbp(sino, theta, 728, 728)
    loop = torch.stack([fbp(sino[i:i + 1], theta[i:i + 1], 728, 728)[0] for i in range(3)])
    torch.cuda.synchronize()
    assert jr.LAUNCHES == before  # no D launch for either
    assert out.shape == (3, 728, 728)
    torch.testing.assert_close(out, loop, rtol=0, atol=0)


def test_merit_rows_on_the_card_at_the_stretch_shape(cuda, monkeypatch):
    """merit_recons at 728 bins, 360 angles onto 512^2 (noise off): row 0
    through kernel D (one launch), equal to the ramp filter and D's plain
    version, cropped and clipped; row 1 on the gather route (no launch),
    equal to a loop of fbp over the examples."""
    from ct_pvae_tpu_torch.data.recon_init import crop_center
    from ct_pvae_tpu_torch.eval import merit
    from ct_pvae_tpu_torch.ops.fbp import fbp, filter_sinogram

    monkeypatch.setattr(merit, "poisson_measurements", lambda x, pnm, gen: x)
    rng = np.random.default_rng(21)
    sinos = rng.uniform(0, 20, (2, 360, 728)).astype(np.float32)
    masks = np.zeros((2, 360), np.float32)
    for i in range(2):
        masks[i, rng.permutation(360)[:20]] = 1.0 / 20
    proj = sinos * masks[:, :, None]
    before = dict(jr.LAUNCHES)
    recon0, recon1 = merit.merit_recons(sinos, masks, proj, _STRETCH_THETA, 1e4, 512, 512, device=cuda)
    assert jr.LAUNCHES == {**before, "joseph_adj_static": before["joseph_adj_static"] + 1}
    s = torch.as_tensor(sinos, device=cuda)
    table = jr.static_table(tuple(float(t) for t in _STRETCH_THETA), 728, 728, cuda)
    plain = jr.radon_fused_adjoint_plain(filter_sinogram(s), table, 728) * (np.pi / (2 * 360))
    want0 = torch.as_tensor(np.clip(crop_center(plain.cpu().numpy(), 512, 512), 0, 1))
    _close(torch.as_tensor(recon0), want0)
    used, theta_used = merit.measured_angles(masks, proj, _STRETCH_THETA)
    loop = torch.stack([fbp(torch.as_tensor(used[i:i + 1], device=cuda),
                            torch.as_tensor(theta_used[i:i + 1], device=cuda), 728, 728)[0]
                        for i in range(2)]).cpu().numpy()
    np.testing.assert_allclose(recon1, np.clip(crop_center(loop, 512, 512), 0, 1), rtol=0, atol=1e-6)


def test_kernel_c_at_the_fidelity_batch(cuda):
    """fidelity's sinograms, chunks of 25 foams at (25, 184, 184) x 180 on
    kernel C (one launch a chunk), against C's plain version."""
    from ct_pvae_tpu_torch.data.sinogram import images_to_sinograms
    from ct_pvae_tpu_torch.ops.radon import pad_phantom

    rng = np.random.default_rng(25)
    imgs = rng.uniform(0, 1, (25, 128, 128)).astype(np.float32)
    before = jr.LAUNCHES["joseph_fwd_static"]
    out = images_to_sinograms(imgs, _THETA, pad=True, batch=25, device=cuda)
    assert jr.LAUNCHES["joseph_fwd_static"] == before + 1
    padded = pad_phantom(torch.as_tensor(imgs, device=cuda), 184)
    want = jr.radon_fused_plain(padded, jr.static_table(tuple(float(t) for t in _THETA), 184, 184, cuda), 184)
    _close(torch.as_tensor(out, device=cuda), want.clamp_min(0.0))


def _inside(events, spans):
    """The events that lie inside one of the Chrome trace spans ``spans``."""
    return [e for e in events if any(float(s["ts"]) <= float(e["ts"])
                                     and float(e["ts"]) + float(e.get("dur", 0))
                                     <= float(s["ts"]) + float(s["dur"]) for s in spans)]


def test_serve_request_waits_for_the_card_once(cuda, tmp_path, monkeypatch):
    """``amortized_infer`` on the card (the step run's weights, kernel A in
    the eval passes, 6 scans in batches of 4, 8 passes): under the profiler
    no CUDA synchronisation or synchronous copy falls inside a batch's span;
    the request holds one wait and one readback; its outputs equal, bitwise,
    the float64 host finish of its passes' maps."""
    import json

    from torch.profiler import ProfilerActivity, profile

    import _torch_infer_finish as finish
    from ct_pvae_tpu_torch.utils import trace
    from ct_pvae_tpu_torch.vi.infer import amortized_infer

    run = tmp_path / "run"
    tr = _step_trainer(cuda, save_path=str(run))
    assert tr.joseph
    tr.checkpoint()
    sinos = np.random.default_rng(3).uniform(0, 5, (6, 24, 64)).astype(np.float32)
    kw = dict(sinograms=sinos, theta=_STEP_THETA, num_passes=8, seed=5, device=cuda,
              overrides={"cheap_init": True})
    amortized_infer(str(run), None, **kw)  # builds, cuDNN's plans, the allocator's blocks
    passes = finish.record_passes(monkeypatch)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = amortized_infer(str(run), None, **kw)
    names = [s.name for s in trace.spans()]
    assert names.count("ctpvae.infer.batch") == 2 and names.count("ctpvae.infer.pass") == 16
    assert names.count("ctpvae.infer.wait") == names.count("ctpvae.infer.readback") == 1
    finish.assert_bitwise(out, finish.host_finish(passes, 6, 4, 8))

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = {n: [e for e in events if e.get("cat") == "user_annotation" and e["name"] == n]
             for n in ("ctpvae.infer.batch", "ctpvae.infer.wait")}
    runtime = [e for e in events if e.get("cat", "").startswith("cuda_")]  # the API's calls
    waits = [e for e in runtime if "Synchronize" in e["name"] or e["name"] == "cudaMemcpy"]
    # control: the trace holds the runtime's calls, the wait's synchronize among them
    assert any(e["name"] == "cudaLaunchKernel" for e in _inside(runtime, spans["ctpvae.infer.batch"]))
    assert _inside(waits, spans["ctpvae.infer.wait"])
    assert _inside(waits, spans["ctpvae.infer.batch"]) == []
