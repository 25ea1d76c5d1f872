"""Toy 2x2 discrete dataset (port of ``ct_pvae_tpu/data/toy.py``).

The reference's layout (scripts/create_toy_images.py:35-41): two fixed
objects, each duplicated, tiled, so that the analytic two-object posterior
applies.  The continuous variant samples the Dirichlet-mixture ``toy_prior``
(toy.py:33-36) from a ``torch.Generator`` seeded with ``seed``: the same
prior as the JAX package's, not the same random numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..prob.distributions import toy_prior

X_TRAIN_0 = np.array([[1, 2], [3, 4]], np.float32) / 10.0
X_TRAIN_1 = np.array([[3, 4], [1, 2]], np.float32) / 10.0


def toy_theta() -> np.ndarray:
    """The toy acquisition angles (images_to_sinograms.py:29)."""
    return np.array([0.0, np.pi / 2], np.float32)


def generate_toy_images(num_tiles: int = 10000, discrete: bool = True, seed: int = 0) -> np.ndarray:
    """Discrete: [x0, x0, x1, x1] tiled ``num_tiles`` times -> (4 * num_tiles, 2, 2).
    Continuous: ``num_tiles`` draws of ``toy_prior`` on the CPU, each a 2x2
    image whose four pixels sum to 1 -> (num_tiles, 2, 2)."""
    if not discrete:
        s = toy_prior().sample(torch.Generator().manual_seed(seed), (num_tiles,))
        return s.numpy().reshape(num_tiles, 2, 2)
    x = np.stack([X_TRAIN_0, X_TRAIN_1], axis=0)
    x = np.repeat(x, repeats=2, axis=0)
    return np.tile(x, (num_tiles, 1, 1))
