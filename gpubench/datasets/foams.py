"""Dataset ``foams``: objects and sinograms made on the device from ``--seed``.

Objects are foams of the paper's family (a unit material disk with circular
voids of radius U(0.01, 0.2) at a porosity target U(0, 1) per object): a
fixed budget of ``VOIDS`` candidate voids per object, largest first, each
placed wholly inside the disk, kept while the voids' summed area is under
the target.  Voids may overlap, which the paper's rejection sampler forbids;
that lowers the porosity a little and is listed under ``assumed`` in the
configuration files.  Each object is rasterised with 2 x 2 supersampling.
Sinograms are the padded objects projected at ``num_angles`` angles over
[0, pi) onto ``detector_bins(n_pixel)`` bins by the reference's Joseph
matrix, clipped at zero, as the repository's ``make-data`` does on the card.

Every draw comes from one ``torch.Generator`` on the device in one call, so
a seed gives the same inputs on every run.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gpubench.inputs import sub_seed
from gpubench.reference.projector import JosephMatrix, pad_to
from gpubench.reference.pvae import detector_bins

VOIDS = 128
SIZE_LOWER, SIZE_UPPER = 0.01, 0.2
SUPERSAMPLE = 2


def foams(n: int, n_pixel: int, seed: int, device: torch.device, chunk: int = 256) -> torch.Tensor:
    """(n, n_pixel, n_pixel) float32 foam objects on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 10))
    u = torch.rand((n, 1 + 4 * VOIDS), generator=gen, device=device, dtype=torch.float64)
    porosity = u[:, :1]
    r = torch.sort(SIZE_LOWER + (SIZE_UPPER - SIZE_LOWER) * u[:, 1:1 + VOIDS], dim=1,
                   descending=True).values
    rho = (1.0 - r) * torch.sqrt(u[:, 1 + VOIDS:1 + 2 * VOIDS])
    phi = 2.0 * np.pi * u[:, 1 + 2 * VOIDS:1 + 3 * VOIDS]
    cx, cy = rho * torch.cos(phi), rho * torch.sin(phi)
    area = torch.cumsum(np.pi * r * r, dim=1) - np.pi * r * r  # area of the voids before each
    keep = area < porosity * np.pi
    r2 = torch.where(keep, r * r, -1.0)                        # a dropped void covers nothing
    m = n_pixel * SUPERSAMPLE
    c = (torch.arange(m, device=device, dtype=torch.float64) + 0.5) / m * 2.0 - 1.0
    xx, yy = c[:, None], c[None, :]
    out = torch.empty((n, n_pixel, n_pixel), device=device)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        solid = (xx * xx + yy * yy <= 1.0).expand(hi - lo, m, m).clone()
        for k in range(VOIDS):
            dx = xx[None] - cx[lo:hi, k, None, None]
            dy = yy[None] - cy[lo:hi, k, None, None]
            solid &= dx * dx + dy * dy > r2[lo:hi, k, None, None]
        img = solid.float().reshape(hi - lo, n_pixel, SUPERSAMPLE, n_pixel, SUPERSAMPLE)
        out[lo:hi] = img.mean(dim=(2, 4))
    return out


def dataset(n: int, n_pixel: int, num_angles: int, seed: int,
            device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """(sinograms (n, num_angles, bins) float32 on the host, theta (num_angles,))."""
    theta = np.linspace(0, np.pi, num_angles, endpoint=False).astype(np.float32)
    bins = detector_bins(n_pixel)
    objects = pad_to(foams(n, n_pixel, seed, device), bins)
    with torch.no_grad():  # 24 angles at a time: one chunk's matrix lives at once
        sinos = torch.cat([JosephMatrix(theta[a0:a0 + 24], bins, bins, device,
                                        adjoint=False)._forward(objects)
                           for a0 in range(0, num_angles, 24)], dim=1)
    return np.ascontiguousarray(torch.clamp(sinos, min=0.0).cpu().numpy()), theta


def make(cfg, seed: int, device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """``dataset`` of the configuration ``cfg``: its ``objects`` foams at
    ``n_pixel``, ``num_angles`` angles."""
    return dataset(cfg["objects"], cfg["n_pixel"], cfg["num_angles"], seed, device)
