"""Kernel D's tap search (``csrc/joseph_adj_static.cu``, which also runs
kernel B), mirrored in numpy.

For a pixel (r, y) and a kernel row, D computes u = (y - offset - slope_r * r)
* (1/slope_t) and k = floor(u + 0.5), and tests with the forward's own hat
the two bins around u (k - 1 and k, or k and k + 1, by the sign of u - k)
and, when |u - k| < 1e-3, the guard bin on the far side of k; it reads them
from a band of bins that starts two
below the smallest k over its 8 x 32 pixel tile's corners, rounded down to
a multiple of 4.  These tests hold
that window against every tap of the forward (kernel C's ``joseph_pos`` /
``joseph_hat``, the plain version's arithmetic) and the band against every
window, on the paper (init) geometry, on the recon geometry that kernels A
and B serve (128^2 onto 184 bins: all 180 angles and a 20-angle subset),
on the stretch recipe's init geometry (728^2 onto 728 bins, the angles of
its 360 at and beside 0, pi/4, pi/2 and 3 pi/4, where the slopes peak and
the major axis turns) and on edge tables, with pos and u computed both with fused multiply-adds
(emulated in float64, then rounded to float32) and without; they run the
whole window search on a small batch against the plain adjoint.  The CUDA
kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import os

import numpy as np
import pytest
import torch

from ct_pvae_tpu_torch.ops import joseph_radon as jr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE_ANGLES = (0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4)
TILE_I, TILE_J, BAND, NEAR = 8, 32, 40, 1e-3  # kTileI, kTileJ, kBand, kNear in joseph_adj_static.cu


def _paper_theta() -> np.ndarray:
    """dataset_foam's 180 angles, as float32 (the init stack's theta)."""
    theta, _ = np.load(os.path.join(REPO, "dataset_foam", "dataset_parameters.npy"),
                       allow_pickle=True)
    return np.asarray(theta, np.float32)


def _fma(a, b, c):
    """float32 fused multiply-add: the float32 product is exact in float64,
    the sum is rounded to float32."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(
        np.float32)


def _mul_add(a, b, c):
    """The same without fusing: the product is rounded to float32 first."""
    return np.asarray(a, np.float32) * np.asarray(b, np.float32) + np.asarray(c, np.float32)


MUL_ADD = {"fused": _fma, "unfused": _mul_add}


def _pos(row, t, r, mul_add):
    """joseph_pos: (offset + slope_t * t) + slope_r * r."""
    return mul_add(row[..., 1], r, mul_add(row[..., 0], t, row[..., 2]))


def _hat(y, pos):
    return np.maximum(np.float32(0), np.float32(1) - np.abs(np.float32(y) - pos))


def _window(row, r, y, mul_add):
    """Kernel D's bins for the pixel (r, y): (t0, guard), the pair t0, t0 + 1
    around u = (y - (offset + slope_r * r)) * (1/slope_t), and the guard bin
    on the far side of k = floor(u + 0.5) when |u - k| < NEAR, else -2**40."""
    u = (np.float32(y) - mul_add(row[..., 1], r, row[..., 2])) * row[..., 5]
    k = np.floor(u + np.float32(0.5))
    d = u - k
    k = k.astype(np.int64)
    t0 = np.where(d < 0, k - 1, k)
    guard = np.where(np.abs(d) < np.float32(NEAR), np.where(d < 0, k + 1, k - 1), -2 ** 40)
    return t0, guard


def _window_centre(row, r, y, mul_add):
    """k of kernel D: floor(u + 0.5)."""
    u = (np.float32(y) - mul_add(row[..., 1], r, row[..., 2])) * row[..., 5]
    return np.floor(u + np.float32(0.5)).astype(np.int64)


def _missed_taps(rows, n, n_det, pos_mul_add, u_mul_add, chunk=20):
    """Walk every forward tap (angle a, ray t, line r, bin y) with a non-zero
    hat, in chunks of angles; return (taps seen, taps outside D's window)."""
    seen = missed = 0
    t = np.arange(n_det, dtype=np.float32)[None, :, None]
    r = np.arange(n, dtype=np.float32)[None, None, :]
    for a0 in range(0, len(rows), chunk):
        row = rows[a0:a0 + chunk][:, None, None, :]                       # (a, 1, 1, 8)
        pos = _pos(row, t, r, pos_mul_add)                                # (a, T, N)
        y0 = np.floor(pos)
        for y in (y0, y0 + np.float32(1)):
            keep = (_hat(y, pos) > 0) & (y >= 0) & (y <= n - 1)
            t0, guard = _window(row, r, y, u_mul_add)
            tt = np.broadcast_to(t, pos.shape).astype(np.int64)
            seen += int(keep.sum())
            missed += int((keep & (tt != t0) & (tt != t0 + 1) & (tt != guard)).sum())
    return seen, missed


# 20 of the 180 angles, drawn as a train step draws them, all past the first 20
RECON_SUBSET = np.sort(np.random.default_rng(20).choice(np.arange(20, 180), 20, replace=False))
# the stretch recipe's 360 angles (configs/foam_stretch.yaml): 12 of them, a
# full walk of all 360 at 728^2 takes minutes
STRETCH_SUBSET = np.array([0, 1, 89, 90, 91, 179, 180, 181, 269, 270, 271, 359])
GEOMETRIES = ["paper", "recon", "recon subset", "stretch", "edge 32x48", "edge 48x32"]


def _geometry(name):
    if name == "paper":
        return _paper_theta(), 184, 184
    if name == "recon":  # the serve and train steps: the 128^2 recon onto 184 bins
        return _paper_theta(), 128, 184
    if name == "recon subset":
        return _paper_theta()[RECON_SUBSET], 128, 184
    if name == "stretch":  # the stretch init stack: 728^2 onto 728 bins
        return np.linspace(0, np.pi, 360, endpoint=False).astype(np.float32)[STRETCH_SUBSET], 728, 728
    theta = np.asarray(EDGE_ANGLES + (np.pi / 4 + 1e-7, np.pi / 4 - 1e-7, 1e-7), np.float32)
    return (theta, 32, 48) if name == "edge 32x48" else (theta, 48, 32)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_kernel_rows_hold_the_table_its_reciprocal_and_the_slope_premise(geometry):
    theta, n, n_det = _geometry(geometry)
    table = jr.angle_table_fused(theta, n, n, n_det)
    rows = jr.kernel_rows(table)
    assert rows.shape == (len(theta), 8) and rows.dtype == np.float32
    np.testing.assert_array_equal(rows[:, :5], table)
    np.testing.assert_array_equal(rows[:, 5], (1.0 / table[:, 0].astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(rows[:, 6:], 0)
    # the window's premise: every row has |slope_t| >= 1, so a pixel meets at most two bins
    assert np.all(np.abs(table[:, 0]) >= 1)
    rows_t = jr.static_rows(tuple(float(x) for x in theta), n, n_det, torch.device("cpu"))
    np.testing.assert_array_equal(rows_t.numpy(), rows)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_adjoint_window_holds_every_forward_tap(geometry):
    """For every (pixel, angle), D's bins (the pair around u, and the guard
    bin when u is within NEAR of an integer) hold every bin whose hat is
    non-zero under the forward's expression, with pos and u computed with
    and without fused multiply-adds."""
    theta, n, n_det = _geometry(geometry)
    rows = jr.kernel_rows(jr.angle_table_fused(theta, n, n, n_det))
    for pos_name, pos_mul_add in MUL_ADD.items():
        for u_name, u_mul_add in MUL_ADD.items():
            seen, missed = _missed_taps(rows, n, n_det, pos_mul_add, u_mul_add)
            assert seen > len(theta) * n  # every angle meets the image
            assert missed == 0, f"pos {pos_name}, u {u_name}: {missed} of {seen} taps outside the window"


def _band_lo(row, i, j, mul_add):
    """Kernel D's first staged bin for the tile of pixel (i, j): the smallest
    k over the tile's four corners, less two, rounded down to a multiple of 4."""
    i0, j0 = i // TILE_I * TILE_I, j // TILE_J * TILE_J
    is_y = row[..., 4] > 0.5
    ks = []
    for ci in (i0, i0 + TILE_I - 1):
        for cj in (j0, j0 + TILE_J - 1):
            ci_f, cj_f = np.float32(ci), np.float32(cj)
            ks.append(_window_centre(row, np.where(is_y, cj_f, ci_f), np.where(is_y, ci_f, cj_f), mul_add))
    return (np.min(ks, axis=0) - 2) // 4 * 4


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_adjoint_band_holds_every_window(geometry):
    """For every (pixel, angle), D's bins, all within k - 1 .. k + 1, lie in
    the band its tile staged."""
    theta, n, n_det = _geometry(geometry)
    rows = jr.kernel_rows(jr.angle_table_fused(theta, n, n, n_det))[:, None, None, :]
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    is_y = rows[..., 4] > 0.5
    r = np.where(is_y, j, i).astype(np.float32)
    y = np.where(is_y, i, j).astype(np.float32)
    for mul_add in MUL_ADD.values():
        k = _window_centre(rows, r, y, mul_add)
        lo = _band_lo(rows, i, j, mul_add)
        assert (k - 1 >= lo).all() and (k + 1 < lo + BAND).all()


def _adjoint_by_window(sino, rows, n):
    """Kernel D's algorithm in numpy: per angle, each pixel's bins (the pair
    and the guard), the forward's hat (pos as ``joseph_pos`` rounds it), hat *
    weight applied to the whole batch."""
    b, a, n_det = sino.shape
    i, j = np.meshgrid(np.arange(n, dtype=np.float32), np.arange(n, dtype=np.float32), indexing="ij")
    out = np.zeros((b, n, n), np.float32)
    for q in range(a):
        row = rows[q]
        rf, yf = (j, i) if row[4] > 0.5 else (i, j)
        t0, guard = _window(row, rf, yf, _fma)
        for t in (t0, t0 + 1, np.maximum(guard, -1)):
            hat = _hat(yf, _pos(row, t.astype(np.float32), rf, _mul_add))
            ok = (t >= 0) & (t < n_det) & (hat > 0)
            w = np.where(ok, hat * row[3], np.float32(0))
            out += w[None] * sino[:, q, np.clip(t, 0, n_det - 1)]
    return out


@pytest.mark.parametrize("n, n_det", [(32, 48), (24, 17)])
def test_window_search_matches_the_plain_adjoint(n, n_det):
    rng = np.random.default_rng(n)
    theta = np.concatenate([np.asarray(EDGE_ANGLES), rng.uniform(0, np.pi, 12)])
    table = jr.angle_table_fused(theta, n, n, n_det)
    sino = rng.normal(size=(3, len(theta), n_det)).astype(np.float32)
    x = rng.uniform(0, 1, (3, n, n)).astype(np.float32)
    out = _adjoint_by_window(sino, jr.kernel_rows(table), n)
    ref = jr.radon_fused_adjoint_plain(torch.from_numpy(sino), torch.from_numpy(table), n).numpy()
    # the same taps (pos rounded as the plain version rounds it), another summation order
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    ax = jr.radon_fused_plain(torch.from_numpy(x), torch.from_numpy(table), n_det).numpy()
    np.testing.assert_allclose(np.sum(ax.astype(np.float64) * sino),
                               np.sum(x.astype(np.float64) * out), rtol=1e-5)


def test_static_kernel_wrappers_take_cuda_tensors_only():
    """On a CPU tensor the wrappers of C and D raise before any build or
    launch: the port's entry points give CPU tensors to the plain versions."""
    from ct_pvae_tpu_torch.ops import _cuda

    theta = tuple(float(t) for t in EDGE_ANGLES)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.joseph_fwd_static(torch.zeros((2, 8, 8)), jr.static_rows(theta, 8, 12, cpu), 12)
    with pytest.raises(ValueError, match="CUDA tensor"):
        _cuda.joseph_adj_static(torch.zeros((2, 4, 12)), jr.static_rows(theta, 8, 12, cpu), 8)
