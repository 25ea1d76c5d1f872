"""Kernel E's tensor-core design (``ct_pvae_tpu_torch/csrc/conv_fused_mma.cu``)
mirrored in numpy on the CPU, against its plain version
(``conv_fused.conv3x3_periodic_maxout_plain``).

The kernel itself runs only on the card (``tests/test_torch_cuda.py``); these
tests hold its arithmetic and its index maps to the plain version here:

  * the 3xTF32 split (big = tf32(v), small = tf32(v - big), rounded to
    nearest with ties away from zero as ``cvt.rna``), its three products
    summed in float32 in the kernel's K order, within the card's tolerance,
    where single TF32 is not;
  * the weight split and its fragment layout, the tiles, the halo with its
    wrap, its split into fragment quads, the channel chunks, the m16n8k8
    fragments, the lane map into the output tile and the tile's store:
    every output is written exactly once and equals the plain version.
"""

import numpy as np
import pytest
import torch

from ct_pvae_tpu_torch.ops import _cuda, conv_fused
from ct_pvae_tpu_torch.scripts.probe_conv_fused import probe_inputs

# conv_fused_mma.cu's constants
TILE, WARPS, CHUNK, HALF_TILES = 16, 8, 8, 5
HALO = TILE + 2
PAIRS = 8 * HALF_TILES
COLS = 2 * PAIRS
QUADS = HALO - 8
X_RAW = HALO * HALO * CHUNK
W_SPLIT = 9 * COLS * 16
# chip_smoke.py's kernel tolerance: rtol 1e-5 plus 1e-5 * max|plain|
RTOL = ATOL_FRAC = 1e-5


def _inputs(b, h, w, c, f):
    x, kern, bias = (t.numpy() for t in probe_inputs(b, max(h, w), c, f, 3, torch.device("cpu")))
    return np.ascontiguousarray(x[:, :h, :w]), kern, bias


def _plain(x, kern, bias):
    return conv_fused.conv3x3_periodic_maxout_plain(
        *(torch.from_numpy(a) for a in (x, kern, bias))).numpy()


def _outside(got, want):
    """How many elements of ``got`` lie outside the card's tolerance of ``want``."""
    tol = RTOL * np.abs(want) + ATOL_FRAC * np.abs(want).max()
    return int((np.abs(got.astype(np.float64) - want) > tol).sum())


def tf32(v):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest, ties away from
    zero (add half of the dropped part to the magnitude's bits, then cut)."""
    bits = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(v):
    big = tf32(v)
    return big, tf32(v - big)


def test_tf32_rounding_is_cvt_rna():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's ulp at 1
    vals = np.array([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                     3.0, 0.0], np.float32)
    want = np.array([one + ulp, one + 2 * ulp, one, -(one + ulp), 3.0, 0.0], np.float32)
    np.testing.assert_array_equal(tf32(vals), want)
    v = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    big, small = split(v)
    assert not (big.view(np.uint32) & 0x1FFF).any() and not (small.view(np.uint32) & 0x1FFF).any()
    # big + small holds v to about 2^-21 of |v|
    assert np.all(np.abs((big.astype(np.float64) + small) - v) <= 2.0 ** -21 * np.abs(v))


def kernel_order_sums(x, kern, bias, products):
    """Bias + maxout of the sums the kernel forms: channel chunks of 8 (zeros
    past C), the nine taps of each chunk, and for each tap the ``products``
    ((A part, B part) pairs) each added to the float32 sums as one 8-deep
    product, in that order."""
    b, h, w, c = x.shape
    f = kern.shape[-1] // 2
    pad = -(-c // CHUNK) * CHUNK - c
    xp = np.pad(np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="wrap"),
                ((0, 0), (0, 0), (0, 0), (0, pad)))
    kp = np.pad(kern, ((0, 0), (0, 0), (0, pad), (0, 0)))
    acc = np.zeros((b * h * w, 2 * f), np.float32)
    for q in range(-(-c // CHUNK)):
        ch = slice(q * CHUNK, (q + 1) * CHUNK)
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            a = xp[:, dy:dy + h, dx:dx + w, ch].reshape(-1, CHUNK)
            parts_a, parts_b = split(a), split(kp[dy, dx, ch, :])
            for pa, pb in products:
                acc = (acc + parts_a[pa] @ parts_b[pb]).astype(np.float32)
    y = (acc + bias).reshape(b, h, w, 2 * f)
    return np.maximum(y[..., :f], y[..., f:])


BIG, SMALL = 0, 1


def test_three_tf32_products_hold_the_card_tolerance_and_one_does_not():
    x, kern, bias = _inputs(2, 16, 16, 40, 40)
    want = _plain(x, kern, bias).astype(np.float64)
    three = kernel_order_sums(x, kern, bias, [(SMALL, BIG), (BIG, SMALL), (BIG, BIG)])
    single = kernel_order_sums(x, kern, bias, [(BIG, BIG)])
    assert three.shape == want.shape == (2, 16, 16, 40)
    assert _outside(three, want) == 0
    assert np.abs(three - want).max() < 1e-6 * np.abs(want).max()
    # single TF32 misses the tolerance at most outputs: the test has teeth
    assert _outside(single, want) > want.size // 2


def _wrap(v, n):
    """conv_fused_mma.cu's wrap: v in [-1, n] wrapped, -1 (zeros) past n."""
    return np.where(v < 0, n - 1, np.where(v < n, v, np.where(v == n, 0, -1)))


def _split_weights(kern, c, f, chunks, groups):
    """split_weights_kernel: B fragments [group][chunk][tap][column][t][4],
    (big 2t, big 2t+1, small 2t, small 2t+1); column n < PAIRS is pair
    f0 + n, n >= PAIRS its partner; zeros past C and F."""
    e = np.arange(groups * chunks * 9 * COLS * CHUNK)
    cc, n = e % CHUNK, (e // CHUNK) % COLS
    tap, q = (e // (CHUNK * COLS)) % 9, (e // (CHUNK * COLS * 9)) % chunks
    group = e // (CHUNK * COLS * 9 * chunks)
    ch = q * CHUNK + cc
    pair = group * PAIRS + np.where(n < PAIRS, n, n - PAIRS)
    o = np.where(n < PAIRS, pair, f + pair)
    ok = (ch < c) & (pair < f)
    big, small = split(np.where(ok, kern.reshape(-1)[np.where(ok, (tap * c + ch) * 2 * f + o, 0)], 0.0))
    out = np.full(2 * e.size, np.nan, np.float32)
    frag = (e - cc) * 2 + (cc >> 1) * 4 + (cc & 1)
    out[frag], out[frag + 2] = big, small
    assert not np.isnan(out).any()
    return out


def _load_halo(x, b, i0, j0, q, vec):
    """copy_halo's halo of one tile for chunk q as copied, [row][column][8],
    by the 16-byte copies (``vec``) or the 4-byte ones."""
    _, h, w, c = x.shape
    per = 2 if vec else CHUNK  # copies per halo pixel
    e = np.arange(HALO * HALO * per)
    px = e // per
    hr = px // HALO
    gi, gj = _wrap(i0 + hr - 1, h), _wrap(j0 + px - hr * HALO - 1, w)
    width = CHUNK // per
    ch = q * CHUNK + width * (e % per)
    ok = (gi >= 0) & (gj >= 0) & (ch < c)
    src = np.where(ok, ((b * h + gi) * w + gj) * c + ch, 0)
    raw = np.full(X_RAW, np.nan, np.float32)
    for k in range(width):  # the floats of one copy
        raw[width * e + k] = np.where(ok, x.reshape(-1)[src + k], 0.0)
    assert not np.isnan(raw).any()
    return raw


def _split_halo(raw):
    """split_halo: A fragments [row][big | small][q][t][4], (column q, column
    q + 8) x (channel 2t, channel 2t + 1), from the raw halo."""
    e = np.arange(HALO * QUADS * 4)
    t, q, r = e & 3, (e >> 2) % QUADS, (e >> 2) // QUADS
    lo = (r * HALO + q) * CHUNK + 2 * t
    hi = (r * HALO + q + 8) * CHUNK + 2 * t
    vals = np.stack([raw[lo], raw[hi], raw[lo + 1], raw[hi + 1]], -1)  # (e, 4)
    big, small = split(vals)
    xs = np.full(HALO * 2 * QUADS * 16, np.nan, np.float32)
    quad = ((r * 2 * QUADS + q) * 4 + t) * 4
    xs[quad[:, None] + np.arange(4)] = big
    xs[quad[:, None] + QUADS * 16 + np.arange(4)] = small
    assert not np.isnan(xs).any()
    return xs


def mirror_kernel(x, kern, bias, vec, sms=132):
    """conv_fused_mma's launch and kernels, block by block and stage by stage,
    the products of the split parts in float64; returns the output and how
    often each element was written."""
    batch, h, w, c = x.shape
    f = kern.shape[-1] // 2
    chunks = -(-c // CHUNK)
    tiles_w = -(-w // TILE)
    tiles_img = -(-h // TILE) * tiles_w
    items = batch * tiles_img
    groups = -(-f // PAIRS)
    blocks = min(items, max(sms // groups, 1))
    wsplit = _split_weights(kern, c, f, chunks, groups)
    out = np.zeros((batch, h, w, f))
    writes = np.zeros((batch, h, w, f), np.int64)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    warp = np.arange(WARPS)[:, None, None]
    mt = np.arange(2)[None, :, None]
    nt = np.arange(2 * HALF_TILES)[:, None]
    for gy in range(groups):
        f0 = gy * PAIRS
        for bx in range(blocks):
            acc = np.zeros((WARPS, 2, 2 * HALF_TILES, 32, 4))
            for s in range(-(-(items - bx) // blocks) * chunks):
                item = bx + (s // chunks) * blocks
                b, r = divmod(item, tiles_img)
                i0, j0 = (r // tiles_w) * TILE, (r % tiles_w) * TILE
                q = s % chunks
                xs = _split_halo(_load_halo(x, b, i0, j0, q, vec)).astype(np.float64)
                ws = wsplit[(gy * chunks + q) * W_SPLIT:][:W_SPLIT].astype(np.float64)
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    # the lanes' registers, as multiply_chunk loads them
                    pa = (((2 * warp + mt + dy) * 2 * QUADS + g + dx) * 4 + t) * 4  # (8, 2, 32)
                    a_parts = (xs[pa[..., None] + np.arange(4)],                  # big
                               xs[pa[..., None] + QUADS * 16 + np.arange(4)])    # small
                    pb = ((tap * COLS + nt * 8 + g) * 4 + t) * 4                     # (10, 32)
                    v = ws[pb[..., None] + np.arange(4)]
                    b_parts = (v[..., :2], v[..., 2:])
                    d = 0.0
                    for part_a, part_b in ((1, 0), (0, 1), (0, 0)):  # small*big, big*small, big*big
                        # registers -> matrices by the m16n8k8 TF32 fragment layout
                        a = a_parts[part_a]
                        am = np.zeros((WARPS, 2, 16, 8))
                        am[:, :, g, t], am[:, :, g + 8, t] = a[..., 0], a[..., 1]
                        am[:, :, g, t + 4], am[:, :, g + 8, t + 4] = a[..., 2], a[..., 3]
                        bm = np.zeros((2 * HALF_TILES, 8, 8))
                        bm[:, t, g], bm[:, t + 4, g] = b_parts[part_b][..., 0], b_parts[part_b][..., 1]
                        d = d + np.einsum("wmik,nkj->wmnij", am, bm)
                    acc[..., 0] += d[..., g, 2 * t]
                    acc[..., 1] += d[..., g, 2 * t + 1]
                    acc[..., 2] += d[..., g + 8, 2 * t]
                    acc[..., 3] += d[..., g + 8, 2 * t + 1]
                if q != chunks - 1:
                    continue
                # finish_item: register r of n-tile n -> pixel g + 8 (r >= 2),
                # pair 8n + 2t + (r & 1) of the tile, partner in n-tile n + 5
                os = np.full(TILE * TILE * PAIRS, np.nan)
                wi, mi, ni, li, ri = np.meshgrid(np.arange(WARPS), np.arange(2), np.arange(HALF_TILES),
                                                 lane, np.arange(4), indexing="ij")
                k = ni * 8 + 2 * (li & 3) + (ri & 1)
                bias0 = np.where(f0 + k < f, bias[np.minimum(f0 + k, f - 1)], 0.0)
                bias1 = np.where(f0 + k < f, bias[f + np.minimum(f0 + k, f - 1)], 0.0)
                slot = ((2 * wi + mi) * TILE + (li >> 2) + 8 * (ri >= 2)) * PAIRS + k
                os[slot] = np.maximum(acc[wi, mi, ni, li, ri] + bias0,
                                      acc[wi, mi, ni + HALF_TILES, li, ri] + bias1)
                assert not np.isnan(os).any()
                # store_tile: the stagers' stores, 16 bytes where F % 4 == 0
                width = 4 if f % 4 == 0 else 1
                e = np.arange(TILE * TILE * PAIRS // width)
                kk, px = e * width % PAIRS, e * width // PAIRS
                i, j = i0 + px // TILE, j0 + px % TILE
                keep = (i < h) & (j < w) & (f0 + kk < f)
                for u in range(width):
                    idx = (b, i[keep], j[keep], f0 + kk[keep] + u)
                    out[idx] = os[(e * width + u)[keep]]
                    np.add.at(writes, idx, 1)
                acc[:] = 0.0
    return out, writes


@pytest.mark.parametrize("b, h, w, c, f, vec, sms", [
    (3, 37, 35, 11, 70, False, 132),  # ragged H and W, a chunk of 3 channels, two pair groups
    (1, 5, 5, 1, 1, False, 132),      # one tile past every edge: the wrap's one-past and zeros
    (2, 16, 16, 40, 40, True, 132),   # the probe's C and F: 16-byte copies
    (2, 16, 16, 40, 40, False, 132),  # the same by 4-byte copies (x off 16 bytes)
    (2, 40, 33, 12, 9, True, 5),      # five blocks walking 18 items; a half chunk of 16 bytes
])
def test_tiles_halo_and_lane_map_write_every_output_once(b, h, w, c, f, vec, sms):
    x, kern, bias = _inputs(b, h, w, c, f)
    out, writes = mirror_kernel(x, kern, bias, vec, sms)
    assert writes.shape == (b, h, w, f) and (writes == 1).all()
    want = _plain(x, kern, bias).astype(np.float64)
    assert _outside(out, want) == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    """On CPU tensors the kernel's wrapper raises before any build; the public
    function takes the plain version and launches nothing."""
    x, kern, bias = (torch.from_numpy(a) for a in _inputs(1, 5, 5, 4, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.conv_fused_mma(x, kern, bias)
    before = conv_fused.LAUNCHES["conv_fused_maxout"]
    out = conv_fused.conv3x3_periodic_maxout(x, kern, bias)
    assert conv_fused.LAUNCHES["conv_fused_maxout"] == before and out.shape == (1, 5, 5, 3)
