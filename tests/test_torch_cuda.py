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
