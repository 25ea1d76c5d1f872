"""Synthetic foam phantom generator (xdesign-free): a copy of
``ct_pvae_tpu/data/foam.py``, so that the port imports nothing of the JAX
package.  The same seed gives bit-identical images in both packages.

The reference builds its foam dataset with ``xdesign.Foam`` +
``xdesign.discrete_phantom`` in a slow per-image Python loop
(scripts/create_foam_images.py:38-42): a unit material disk with
non-overlapping circular voids, void radii in ``[size_lower, size_upper]``,
target void fraction ("porosity") drawn per image.  This module reproduces the
*distribution family* (SURVEY.md hard-part #5: distribution compatibility, not
pixel equality) with a vectorized numpy circle-packing sampler and an
antialiased rasterizer.  Shapes/values match the reference contract:
``(num_train, N_PIXEL, N_PIXEL)`` float images in [0, 1].
"""

from __future__ import annotations

import numpy as np

# Reference defaults (create_foam_images.py:24-28)
N_PIXEL = 128
SIZE_LOWER = 0.01
SIZE_UPPER = 0.2
GAP = 0.0


def _pack_voids(
    rng: np.random.Generator,
    porosity: float,
    size_lower: float,
    size_upper: float,
    gap: float,
    max_attempts: int = 3000,
):
    """Greedy circle packing with adaptive radius shrinking.

    Phase 1 is dart throwing with radii in descending order (big voids land
    first, like xdesign's descending size_range).  Fixed-radius dart throwing
    alone saturates near 0.65 void fraction while the reference recipe draws
    targets from U(0, 1) (create_foam_images.py:39), so when a sweep stops
    placing circles the proposal range shrinks toward ``size_lower`` —
    mirroring xdesign's insertion loop, which keeps retrying ever-smaller
    circles until the porosity target is met.  High targets (>~0.85) remain
    geometrically unreachable with non-overlapping r>=size_lower circles;
    both generators saturate there.
    """
    target_area = porosity * np.pi  # material disk has radius 1, area pi
    centers = np.zeros((0, 2), np.float64)
    radii = np.zeros((0,), np.float64)
    area = 0.0
    hi = size_upper
    for _sweep in range(8):
        if area >= target_area:
            break
        proposal_r = np.sort(rng.uniform(size_lower, hi, size=max_attempts))[::-1]
        proposal_xy = rng.uniform(-1.0, 1.0, size=(max_attempts, 2))
        placed = 0
        for i in range(max_attempts):
            if area >= target_area:
                break
            r = proposal_r[i]
            c = proposal_xy[i]
            # fully inside the material disk
            if np.hypot(c[0], c[1]) + r > 1.0:
                continue
            if radii.size:
                d = np.hypot(centers[:, 0] - c[0], centers[:, 1] - c[1])
                if np.any(d < radii + r + gap):
                    continue
            centers = np.vstack([centers, c[None]])
            radii = np.append(radii, r)
            area += np.pi * r * r
            placed += 1
        # next sweep proposes smaller circles for the remaining gaps
        hi = max(size_lower, hi * 0.5)
        if placed == 0 and hi <= size_lower:
            break
    return centers, radii


def _rasterize(centers, radii, n_pixel: int, supersample: int = 2) -> np.ndarray:
    """Antialiased rasterization: 1 inside the material disk, 0 in voids."""
    n = n_pixel * supersample
    # pixel centers over [-1, 1]
    coords = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    xx, yy = np.meshgrid(coords, coords, indexing="ij")
    rr = np.hypot(xx, yy)
    img = (rr <= 1.0).astype(np.float32)
    for (cx, cy), r in zip(centers, radii):
        img[np.hypot(xx - cx, yy - cy) <= r] = 0.0
    if supersample > 1:
        img = img.reshape(n_pixel, supersample, n_pixel, supersample).mean(axis=(1, 3))
    return img


def generate_foam_images(
    num_train: int,
    n_pixel: int = N_PIXEL,
    size_lower: float = SIZE_LOWER,
    size_upper: float = SIZE_UPPER,
    gap: float = GAP,
    seed: int = 0,
) -> np.ndarray:
    """Generate the foam training set.

    Per-image porosity ~ U(0, 1) as in the reference
    (create_foam_images.py:39 ``porosity=np.random.rand()``); explicit seeding
    replaces the reference's module-level ``np.random.seed(0)``.

    Returns: (num_train, n_pixel, n_pixel) float32 in [0, 1].
    """
    rng = np.random.default_rng(seed)
    out = np.empty((num_train, n_pixel, n_pixel), np.float32)
    for i in range(num_train):
        porosity = rng.uniform()
        centers, radii = _pack_voids(rng, porosity, size_lower, size_upper, gap)
        out[i] = _rasterize(centers, radii, n_pixel)
    return out
