"""Projector geometry, the gather projector and the pixel-driven backprojector
(port of ``ops/radon.py``).

Geometry convention shared with ``fbp.py`` and the Joseph projector:

  * image f[x, y], centred coordinates X = x - (H-1)/2, Y = y - (W-1)/2
  * a point (X, Y) hits detector coordinate t_hat = Y cos(theta) - X sin(theta)

Counterparts: ``num_proj_pixels`` and ``pad_phantom`` (radon.py:44-68), the
gather projector ``radon`` with ``_sample_grid`` and ``_bilinear_taps``
(radon.py:71-159), ``radon_low_mem`` (radon.py:162-196), ``radon_fast``
(radon.py:199-229), the chunked pixel-driven ``backproject``
(radon.py:232-304) and ``rotate_image`` (radon.py:307-348).

``radon_fast`` takes concrete angles and routes as the JAX package does:
the static Joseph projector (``radon_static``, kernel C) on a CUDA tensor,
where the JAX package takes its Pallas kernel on a TPU, and the gather
``radon`` on any other tensor, as the JAX package does off the TPU.

``radon`` is XLA code in the JAX package, not a Pallas kernel, so plain torch
is its port: four bilinear gathers over a static (A, S, P) sample grid.
Autograd differentiates it; the gathers' backward is torch's scatter-add, as
JAX's transpose of ``take`` is.  ``CALLS`` counts its calls, so a run can
show that it took the gather route rather than the Joseph kernels.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CALLS = {"radon": 0}


def num_proj_pixels(h: int, w: int) -> int:
    """Detector size for a padded projection of an (h, w) image:
    ceil((sqrt(h^2+w^2)+2)/2) * 2 (reference forward_functions.py:29-30)."""
    p = math.sqrt(h * h + w * w) + 2.0
    return int(math.ceil(p / 2.0) * 2)


def pad_phantom(phantom: torch.Tensor, n_det: Optional[int] = None) -> torch.Tensor:
    """Zero-pad the trailing two dims to (n_det, n_det): ``pad//2`` in front,
    the remainder at the back (reference forward_functions.py:32-44)."""
    h, w = phantom.shape[-2], phantom.shape[-1]
    if n_det is None:
        n_det = num_proj_pixels(h, w)
    padx, pady = n_det - h, n_det - w
    return F.pad(phantom, (pady // 2, pady - pady // 2, padx // 2, padx - padx // 2))


def _sample_grid(theta: torch.Tensor, n_s: int, n_det: int, h: int,
                 w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Array coordinates (x, y), each (A, n_s, n_det), of every ray step
    (radon.py:71-86): unit steps s along u = (cos, sin), t_hat along
    v = (-sin, cos), about the image centre."""
    dev = theta.device
    f32 = dict(dtype=torch.float32, device=dev)
    s = (torch.arange(n_s, **f32) - (n_s - 1) / 2.0)[None, :, None]
    t_hat = (torch.arange(n_det, **f32) - (n_det - 1) / 2.0)[None, None, :]
    cos = torch.cos(theta.float())[:, None, None]
    sin = torch.sin(theta.float())[:, None, None]
    x = s * cos - t_hat * sin + (h - 1) / 2.0
    y = s * sin + t_hat * cos + (w - 1) / 2.0
    return x, y


def _bilinear_taps(x: torch.Tensor, y: torch.Tensor, h: int,
                   w: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The 4 bilinear taps as (flat index into an (h, w) image, weight);
    taps outside the image get weight 0 (radon.py:89-113)."""
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    taps = []
    for dx, dy, wgt in (
        (0, 0, (1 - wx) * (1 - wy)),
        (1, 0, wx * (1 - wy)),
        (0, 1, (1 - wx) * wy),
        (1, 1, wx * wy),
    ):
        xi, yi = x0 + dx, y0 + dy
        valid = (xi >= 0) & (xi <= h - 1) & (yi >= 0) & (yi <= w - 1)
        flat = xi.clamp(0, h - 1).long() * w + yi.clamp(0, w - 1).long()
        taps.append((flat, torch.where(valid, wgt, 0.0)))
    return taps


def radon(image: torch.Tensor, theta: torch.Tensor, *, pad: bool = False,
          n_det: Optional[int] = None) -> torch.Tensor:
    """Radon transform of (..., H, W) images at the (A,) angles ``theta``:
    (..., A, n_det), with ``n_s = H`` unit ray steps (radon.py:116-159).

    ``pad`` zero-pads the image to (n_det, n_det) first; ``n_det`` defaults
    to H after the optional pad, which needs a square image.
    """
    return FixedAngleRadon(theta, image.shape[-2], image.shape[-1], pad=pad, n_det=n_det,
                           device=image.device)(image)


class FixedAngleRadon:
    """``radon`` at fixed angles and image size, its bilinear taps found once:
    the samplers project at the same angles thousands of times."""

    def __init__(self, theta, h: int, w: int, *, pad: bool = False, n_det: Optional[int] = None,
                 device=None):
        if pad:
            n_det = num_proj_pixels(h, w) if n_det is None else n_det
            h = w = n_det
        elif n_det is None:
            if h != w:
                raise ValueError("unpadded radon requires square images; use pad=True")
            n_det = h
        self.pad, self.n_det, self.h, self.w = pad, n_det, h, w
        theta = torch.as_tensor(theta, device=device)
        self.a = theta.shape[0]
        self.taps = _bilinear_taps(*_sample_grid(theta, h, n_det, h, w), h, w)  # n_s = h unit steps

    def __call__(self, image: torch.Tensor) -> torch.Tensor:
        if self.pad:
            image = pad_phantom(image, self.n_det)
        CALLS["radon"] += 1
        batch_shape = image.shape[:-2]
        img_flat = image.reshape(-1, self.h * self.w)
        sino = 0.0
        for flat, wgt in self.taps:
            vals = img_flat.index_select(1, flat.reshape(-1)).reshape(-1, self.a, self.h, self.n_det)
            sino = sino + vals * wgt[None]
        return sino.sum(dim=2).reshape(batch_shape + (self.a, self.n_det))


def radon_low_mem(image: torch.Tensor, theta: torch.Tensor, *, pad: bool = False,
                  n_det: Optional[int] = None, angle_chunk: int = 8) -> torch.Tensor:
    """``radon`` over chunks of ``angle_chunk`` angles, which bounds the live
    (B, chunk, S, P) gather (radon.py:162-196); the angle count must be a
    multiple of ``angle_chunk``."""
    if pad:
        image = pad_phantom(image, n_det)
    h, w = image.shape[-2], image.shape[-1]
    if n_det is None:
        if h != w:
            raise ValueError("unpadded radon requires square images; use pad=True")
        n_det = h
    theta = torch.as_tensor(theta, device=image.device)
    a = theta.shape[0]
    if a % angle_chunk != 0:
        raise ValueError(f"angle count {a} not divisible by angle_chunk {angle_chunk}")
    chunks = [radon(image, theta[a0:a0 + angle_chunk], n_det=n_det) for a0 in range(0, a, angle_chunk)]
    return torch.cat(chunks, dim=-2)


def radon_fast(image: torch.Tensor, theta, *, pad: bool = False,
               n_det: Optional[int] = None) -> torch.Tensor:
    """Radon transform at concrete angles ``theta`` (radon.py:199-229):
    kernel C (``radon_static``) on a CUDA tensor, the gather ``radon`` on
    any other.  (..., H, W) -> (..., A, n_det)."""
    theta_np = np.asarray(torch.as_tensor(theta).cpu(), np.float32)
    if image.device.type != "cuda":
        return radon(image, torch.as_tensor(theta_np), pad=pad, n_det=n_det)
    from .joseph_radon import radon_static

    if pad:
        image = pad_phantom(image, n_det)
    h, w = image.shape[-2], image.shape[-1]
    if n_det is None:
        n_det = h
    flat = image.reshape((-1, h, w)).float().contiguous()  # radon_static takes square images only
    out = radon_static(flat, tuple(float(t) for t in theta_np), n_det)
    return out.reshape(image.shape[:-2] + (len(theta_np), n_det))


def backproject(
    sinogram: torch.Tensor,
    theta: torch.Tensor,
    x_size: int,
    y_size: int,
    angle_chunk: int = 32,
) -> torch.Tensor:
    """Pixel-driven (unfiltered) backprojection, (..., A, P) -> (..., x, y).

    Each output pixel linearly interpolates every angle's projection at
    t = Y cos(theta) - X sin(theta) + c_t with clamped edges, and sums over
    angles.  Angles are taken ``angle_chunk`` at a time (summed within a
    chunk, then across chunks, as the reference's scan does), which bounds
    the live (B, chunk, X, Y) gather.  ``theta`` is (A,), shared by every
    sinogram, or (..., A), one angle set per sinogram (the JAX package's
    ``vmap`` over per-example angles): each sinogram then backprojects
    through its own angles, as a loop over the examples would.
    """
    a, p = sinogram.shape[-2], sinogram.shape[-1]
    batch_shape = sinogram.shape[:-2]
    sino = sinogram.reshape((-1, a, p)).float()
    b = sino.shape[0]
    dev = sino.device
    theta = torch.as_tensor(theta, dtype=torch.float32, device=dev)
    if theta.dim() > 1:
        if tuple(theta.shape) != tuple(batch_shape) + (a,):
            raise ValueError(f"per-example theta {tuple(theta.shape)} does not match sinograms "
                             f"{tuple(sinogram.shape)}")
        theta = theta.reshape(b, a)

    cx = (x_size - 1) / 2.0
    cy = (y_size - 1) / 2.0
    ct = (p - 1) / 2.0
    xg = (torch.arange(x_size, dtype=torch.float32, device=dev) - cx)[:, None]
    yg = (torch.arange(y_size, dtype=torch.float32, device=dev) - cy)[None, :]

    chunk = max(1, min(int(angle_chunk), a))
    out = torch.zeros((b, x_size, y_size), dtype=torch.float32, device=dev)
    for a0 in range(0, a, chunk):
        th = theta[..., a0 : a0 + chunk]                       # (c,) or (B, c)
        c = th.shape[-1]
        sino_c = sino[:, a0 : a0 + chunk]                      # (B, c, P)
        cos = torch.cos(th)[..., None, None]
        sin = torch.sin(th)[..., None, None]
        t = yg * cos - xg * sin + ct                           # (c, X, Y) or (B, c, X, Y)
        t0 = torch.floor(t)
        wt = (t - t0).reshape(-1, c, x_size * y_size)
        i0 = t0.clamp(0, p - 1).long().reshape(-1, c, x_size * y_size).expand(b, -1, -1)
        i1 = (t0 + 1).clamp(0, p - 1).long().reshape(-1, c, x_size * y_size).expand(b, -1, -1)
        v0 = torch.gather(sino_c, 2, i0)
        v1 = torch.gather(sino_c, 2, i1)
        v = v0 * (1 - wt) + v1 * wt                            # (B, c, X*Y)
        out = out + v.sum(dim=1).reshape(b, x_size, y_size)
    return out.reshape(batch_shape + (x_size, y_size))


def rotate_image(images: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Bilinear centre rotation, one angle (radians) per image, zero fill
    outside the support: (B, H, W) or (B, H, W, C) (radon.py:307-348).
    Positive angles turn the object the way the projector's angle axis
    advances, so radon(rotate_image(x, theta_k)) is the sinogram rolled by k
    rows (``vi/augment.py``)."""
    squeeze = images.dim() == 3
    if squeeze:
        images = images[..., None]
    b, h, w, c = images.shape
    dev = images.device
    cx, cy = (h - 1) / 2.0, (w - 1) / 2.0
    xg, yg = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    angles = torch.as_tensor(angles, device=dev).float()[:, None, None]
    cos, sin = torch.cos(angles), torch.sin(angles)
    # sample the source at coordinates rotated by -angle (pull-back)
    xs = cos * (xg - cx) + sin * (yg - cy) + cx
    ys = -sin * (xg - cx) + cos * (yg - cy) + cy
    flat = images.reshape(b, h * w, c)
    out = 0
    for fi, wg in _bilinear_taps(xs, ys, h, w):
        vals = torch.gather(flat, 1, fi.reshape(b, h * w, 1).expand(-1, -1, c))
        out = out + vals.reshape(b, h, w, c) * wg[..., None]
    return out[..., 0] if squeeze else out
