"""Plain projectors and classical reconstructions of the P-VAE's measurement model.

The benchmark's own copy, in plain PyTorch: it imports nothing of the
program.  The geometry is the one the paper's code fixes (image f[x, y]
about its centre, a point hitting detector coordinate Y cos(theta) - X sin(theta)):

  * ``JosephMatrix``: the Joseph projector (the image stepped along its
    major axis, two linear-interpolation taps per image row and ray, the
    ray weight 1/|cos| or 1/|sin| folded in) as a sparse matrix, with its
    exact transpose as the adjoint.  This is the discretisation the CUDA
    kernels A-D compute.
  * ``backproject_pixel``: the pixel-driven backprojector (every pixel
    interpolates each angle's row linearly, edges clamped).
  * ``fbp``, ``sirt``, ``tv``: the init channels, written from their
    equations (Kak and Slaney's band-limited ramp; SIRT with row and column
    inverse sums; Chambolle-Pock TV with lam 0.05, sigma 0.5, tau 1e-3).

``joseph_taps`` also gives the operation count of a Joseph call
(``gpubench/counts.py``): the in-range taps of every ray.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def angle_table(theta: np.ndarray, n: int, n_det: int) -> np.ndarray:
    """(A, 5) float32 rows (slope_t, slope_r, offset, weight, is_y_major) of
    an n x n image onto ``n_det`` bins: a ray at detector bin t meets image
    row r (column r where the ray runs closer to the y axis) at
    offset + slope_t t + slope_r r; computed in float64, rounded once."""
    theta = np.asarray(theta, np.float64)
    c, s = np.cos(theta), np.sin(theta)
    cx = cy = (n - 1) / 2.0
    ct = (n_det - 1) / 2.0
    x_major = np.abs(c) >= np.abs(s)
    sc = np.where(x_major, c, 1.0)
    ss = np.where(~x_major, s, 1.0)
    tab = np.stack((
        np.where(x_major, 1.0 / sc, -1.0 / ss),
        np.where(x_major, s / sc, c / ss),
        np.where(x_major, cy - ct / sc - cx * (s / sc), cx + ct / ss - cy * (c / ss)),
        np.where(x_major, 1.0 / np.abs(sc), 1.0 / np.abs(ss)),
        np.where(x_major, 0.0, 1.0),
    ), axis=-1)
    return tab.astype(np.float32)


def joseph_taps(table: torch.Tensor, n: int, n_det: int, chunk: int = 24,
                count_only: bool = False):
    """The in-range taps of every ray as (ray, pixel, value) with the ray
    weight folded in, or, with ``count_only``, their number.  Taps are found
    in float32 as (offset + slope_t t) + slope_r r, 24 angles at a time."""
    dev = table.device
    t = torch.arange(n_det, dtype=torch.float32, device=dev)[None, :, None]
    r = torch.arange(n, dtype=torch.float32, device=dev)[None, None, :]
    rays, pixels, values, count = [], [], [], 0
    for a0 in range(0, table.shape[0], chunk):
        tab = table[a0:a0 + chunk]
        col = lambda i: tab[:, i][:, None, None]
        pos = (col(2) + col(0) * t) + col(1) * r                 # (chunk, T, N)
        y0 = torch.floor(pos)
        is_y = col(4) > 0.5
        for yk in (y0, y0 + 1.0):
            keep = (yk >= 0) & (yk <= n - 1)
            if count_only:
                count += int(keep.sum())
                continue
            ray = ((a0 + torch.arange(tab.shape[0], device=dev))[:, None, None] * n_det
                   + torch.arange(n_det, device=dev)[None, :, None]).expand_as(pos)
            hat = torch.clamp(1.0 - torch.abs(yk - pos), min=0.0) * col(3)
            yi, ri = yk.long(), r.long().expand_as(pos)
            pix = torch.where(is_y, yi * n + ri, ri * n + yi)
            rays.append(ray[keep])
            pixels.append(pix[keep])
            values.append(hat[keep])
    if count_only:
        return count
    return torch.cat(rays), torch.cat(pixels), torch.cat(values)


def _csr(rows, cols, vals, shape) -> torch.Tensor:
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape, check_invariants=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "sparse CSR support is in beta"
        return coo.coalesce().to_sparse_csr()


class JosephMatrix:
    """The Joseph projector of an n x n image at ``theta`` onto ``n_det``
    bins as CSR matrices, one per ``chunk`` angles (which bounds the
    temporaries of the build), with their transposes for the adjoint.
    ``forward`` / ``adjoint`` False leaves that direction out."""

    def __init__(self, theta: np.ndarray, n: int, n_det: int, device: torch.device,
                 forward: bool = True, adjoint: bool = True, chunk: int = 24):
        self.n, self.n_det, self.a = n, n_det, len(theta)
        table = torch.as_tensor(angle_table(theta, n, n_det), device=device)
        self.fwd, self.adj = [], []
        for a0 in range(0, self.a, chunk):
            part = table[a0:a0 + chunk]
            rays, pix, vals = joseph_taps(part, n, n_det)
            shape = (len(part) * n_det, n * n)
            if forward:
                self.fwd.append(_csr(rays, pix, vals, shape))
            if adjoint:
                self.adj.append(_csr(pix, rays, vals, shape[::-1]))

    def project(self, img: torch.Tensor) -> torch.Tensor:
        """(B, n, n) -> (B, A, n_det), differentiable (adjoint backward)."""
        return _Project.apply(img, self)

    def adjoint(self, sino: torch.Tensor) -> torch.Tensor:
        """(B, A, n_det) -> (B, n, n), the exact transpose of ``project``."""
        b = sino.shape[0]
        cols = sino.reshape(b, self.a * self.n_det).t()
        out, lo = None, 0
        for mat in self.adj:
            part = torch.sparse.mm(mat, cols[lo:lo + mat.shape[1]].contiguous())
            out = part if out is None else out + part
            lo += mat.shape[1]
        return out.t().reshape(b, self.n, self.n)

    def _forward(self, img: torch.Tensor) -> torch.Tensor:
        b = img.shape[0]
        cols = img.reshape(b, -1).t().contiguous()
        out = torch.cat([torch.sparse.mm(mat, cols) for mat in self.fwd])
        return out.t().reshape(b, self.a, self.n_det)


class _Project(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, mat):
        ctx.mat = mat
        return mat._forward(img)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mat.adjoint(grad), None


def pad_to(img: torch.Tensor, n_det: int) -> torch.Tensor:
    """Zero-pad the trailing two dims to (n_det, n_det), the odd pixel at the back."""
    px, py = n_det - img.shape[-2], n_det - img.shape[-1]
    return torch.nn.functional.pad(img, (py // 2, py - py // 2, px // 2, px - px // 2))


def backproject_pixel(sino: torch.Tensor, theta: torch.Tensor, size: int,
                      chunk: int = 32) -> torch.Tensor:
    """Pixel-driven backprojection (B, A, P) -> (B, size, size) at one angle
    set: each pixel interpolates every angle's row at
    t = Y cos - X sin + (P-1)/2, edges clamped; angles summed in chunks."""
    b, a, p = sino.shape
    dev = sino.device
    c = (size - 1) / 2.0
    xg = (torch.arange(size, dtype=torch.float32, device=dev) - c)[:, None]
    yg = (torch.arange(size, dtype=torch.float32, device=dev) - c)[None, :]
    out = torch.zeros((b, size, size), dtype=torch.float32, device=dev)
    for a0 in range(0, a, chunk):
        th = theta[a0:a0 + chunk]
        k = th.shape[0]
        t = yg * torch.cos(th)[:, None, None] - xg * torch.sin(th)[:, None, None] + (p - 1) / 2.0
        t0 = torch.floor(t)
        wt = (t - t0).reshape(1, k, -1)
        i0 = t0.clamp(0, p - 1).long().reshape(1, k, -1).expand(b, -1, -1)
        i1 = (t0 + 1).clamp(0, p - 1).long().reshape(1, k, -1).expand(b, -1, -1)
        part = sino[:, a0:a0 + chunk]
        v = torch.gather(part, 2, i0) * (1 - wt) + torch.gather(part, 2, i1) * wt
        out = out + v.sum(dim=1).reshape(b, size, size)
    return out


def ramp_filter(size: int, name: str) -> np.ndarray:
    """Kak and Slaney's band-limited ramp of length ``size`` in the FFT
    layout, times sinc for shepp-logan; all ones for 'none'."""
    if name == "none":
        return np.ones(size)
    f = np.zeros(size)
    f[0] = 0.25
    pos = np.arange(1, size // 2 + 1)
    pos = pos[pos % 2 == 1]
    f[pos] = -1.0 / (np.pi * pos) ** 2
    neg = np.arange(1, (size + 1) // 2)
    neg = neg[neg % 2 == 1]
    f[size - neg] = -1.0 / (np.pi * neg) ** 2
    omega = 2.0 * np.real(np.fft.fft(f))
    if name == "shepp-logan":
        w = np.pi * np.fft.fftfreq(size)[1:]
        omega[1:] *= np.sin(w) / w
    elif name != "ramp":
        raise ValueError(f"filter {name!r} is not in the reference")
    return omega


def fbp(sino: torch.Tensor, theta: np.ndarray, size: int, filter_name: str,
        backproject: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Filtered backprojection (B, A, P) -> (B, size, size) with the uniform
    pi / (2A) angle weight; ``backproject`` is the geometry's adjoint."""
    p = sino.shape[-1]
    omega = torch.as_tensor(ramp_filter(p, filter_name)[: p // 2 + 1], dtype=torch.float32,
                            device=sino.device)
    filtered = torch.fft.irfft(torch.fft.rfft(sino, dim=-1) * omega, n=p, dim=-1)
    return backproject(filtered) * (math.pi / (2.0 * len(theta)))


def sirt(sino: torch.Tensor, fwd, adj, size: int, iters: int = 30) -> torch.Tensor:
    """x <- relu(x + C A^T R (p - A x)), R = 1 / (A 1), C = 1 / (A^T 1)."""
    ones = torch.ones(sino.shape[:-2] + (size, size), device=sino.device)
    r = 1.0 / torch.clamp(fwd(ones), min=1e-6)
    c = 1.0 / torch.clamp(adj(torch.ones_like(sino)), min=1e-6)
    x = torch.zeros_like(ones)
    for _ in range(iters):
        x = torch.relu(x + c * adj(r * (sino - fwd(x))))
    return x


def tv(sino: torch.Tensor, fwd, adj, size: int, iters: int = 60, lam: float = 0.05,
       sigma: float = 0.5, tau: float = 1e-3) -> torch.Tensor:
    """Chambolle-Pock for 0.5 ||A x - p||^2 + lam TV(x), forward differences
    with the last row and column repeated."""
    x = torch.zeros(sino.shape[:-2] + (size, size), device=sino.device)
    xbar, y_fid = x, torch.zeros_like(sino)
    y_gx, y_gy = torch.zeros_like(x), torch.zeros_like(x)
    for _ in range(iters):
        y_fid = (y_fid + sigma * (fwd(xbar) - sino)) / (1.0 + sigma)
        gx = torch.diff(xbar, dim=-2, append=xbar[..., -1:, :])
        gy = torch.diff(xbar, dim=-1, append=xbar[..., :, -1:])
        y_gx, y_gy = y_gx + sigma * gx, y_gy + sigma * gy
        scale = torch.clamp(torch.sqrt(y_gx ** 2 + y_gy ** 2) / lam, min=1.0)
        y_gx, y_gy = y_gx / scale, y_gy / scale
        div = (torch.cat([y_gx[..., :1, :], y_gx[..., 1:-1, :] - y_gx[..., :-2, :],
                          -y_gx[..., -2:-1, :]], dim=-2)
               + torch.cat([y_gy[..., :, :1], y_gy[..., :, 1:-1] - y_gy[..., :, :-2],
                            -y_gy[..., :, -2:-1]], dim=-1))
        x_new = torch.relu(x - tau * (adj(y_fid) - div))
        xbar, x = 2.0 * x_new - x, x_new
    return x


def crop_center(img: torch.Tensor, size: int) -> torch.Tensor:
    """Centre crop of the trailing two dims to size x size."""
    n = img.shape[-1]
    lo = n // 2 - size // 2
    return img[..., lo:lo + size, lo:lo + size]


def init_stack(proj: torch.Tensor, masks: torch.Tensor, theta: np.ndarray,
               algorithms: Sequence[str], size: int,
               joseph_full: Callable[[bool], JosephMatrix]) -> torch.Tensor:
    """The encoder's input (B, size, size, len(algorithms) + 1): each
    algorithm's reconstruction of the mask-unnormalised sparse sinogram at
    detector resolution, centre-cropped, then the unfiltered backprojection
    of the mask.  The FBP channels backproject through the Joseph transpose
    from 512 detector bins on, pixel-driven below; sirt and tv run on the
    Joseph pair.  ``joseph_full(forward)``: the Joseph matrix of the full
    angle set on a P x P image (its forward too where ``forward``)."""
    b, a, p = proj.shape
    m = masks[:, :, None].expand(b, a, p)
    measured = m > _EPS32
    unnorm = torch.where(measured, proj / torch.where(measured, m, 1.0), proj)
    theta_t = torch.as_tensor(np.asarray(theta, np.float32), device=proj.device)
    iterative = any(alg in ("sirt", "tv") for alg in algorithms)
    if p >= 512:
        back = lambda s: joseph_full(iterative).adjoint(s)
    else:
        back = lambda s: backproject_pixel(s, theta_t, p)
    chans = []
    for alg in algorithms:
        if alg == "gridrec":
            chans.append(fbp(unnorm, theta, p, "ramp", back))
        elif alg == "fbp":
            chans.append(fbp(unnorm, theta, p, "shepp-logan", back))
        elif alg == "sirt":
            jm = joseph_full(True)
            chans.append(sirt(unnorm, jm.project, jm.adjoint, p))
        elif alg == "tv":
            jm = joseph_full(True)
            chans.append(tv(unnorm, jm.project, jm.adjoint, p))
        else:
            raise ValueError(f"init algorithm {alg!r} is not in the reference")
    chans.append(fbp(m.contiguous(), theta, p, "none", back))
    return crop_center(torch.stack(chans, dim=-1).movedim(-1, 1), size).movedim(1, -1).contiguous()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 stored mantissa bits, round to nearest even),
    kept in float32: what the tensor cores read in TF32 mode."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    rounded = (i + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)
