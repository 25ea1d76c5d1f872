"""Sparse-angle masks and Poisson measurements (port of ``data/masks.py``).

``make_masks`` is a numpy copy of the reference (``masks.py:20-61``), so the
masks are bitwise equal to the JAX package's.  The Poisson draw runs on the
device with ``torch.poisson`` and a seeded ``torch.Generator`` in place of
``jax.random.poisson`` (``masks.py:106-116``): the same distribution, not the
same random numbers.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch


def make_masks(
    num_examples: int,
    num_angles: int,
    num_sparse_angles: int,
    random: bool = False,
    toy_masks: bool = False,
    seed: int = 0,
) -> np.ndarray:
    """(N, A) float mask array, scaled by 1/num_sparse_angles."""
    if toy_masks:
        if num_angles != 2:
            raise ValueError(
                f"toy_masks requires num_angles == 2 (got {num_angles}); the "
                "patterns are the fixed 2-angle alternation of create_masks.py:37-42"
            )
        base = np.array([[1, 0], [0, 1], [1, 0], [0, 1]], np.float32)
        reps = int(np.ceil(num_examples / 4))
        masks = np.tile(base, (reps, 1))[:num_examples]
        return masks / num_sparse_angles

    rng = np.random.default_rng(seed)
    masks = np.zeros((num_examples, num_angles), np.float32)
    if random:
        for i in range(num_examples):
            idx = rng.permutation(num_angles)[:num_sparse_angles]
            masks[i, idx] = 1.0
    else:
        spacing = int(np.ceil(num_angles / num_sparse_angles))
        idx = (np.arange(num_sparse_angles) * spacing) % num_angles
        masks[:, idx] = 1.0
    return masks / num_sparse_angles


def poisson_measurements(
    proj_masked: torch.Tensor, poisson_noise_multiplier: float, generator: torch.Generator
) -> torch.Tensor:
    """``Poisson(proj_masked * pnm) / pnm`` drawn on ``proj_masked``'s device."""
    rate = proj_masked * poisson_noise_multiplier
    return torch.poisson(rate, generator=generator) / poisson_noise_multiplier


def create_all_masks(
    x_train_sinograms: np.ndarray,
    num_angles: int,
    device: torch.device,
    save_path: Optional[str] = None,
    poisson_noise_multiplier: float = 1e3,
    num_sparse_angles: int = 10,
    random: bool = False,
    real_data: bool = False,
    truncate_dataset: int = 100,
    toy_masks: bool = False,
    seed: int = 0,
    reuse_cache: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """(all_masks (N, A), all_proj_samples (N, A, P)) as host arrays.

    The serving counterpart of ``create_all_masks`` in train mode: masks and
    measurements are generated for the given sinograms (``real_data`` passes
    the masked sinograms through un-noised), written under ``save_path``,
    and reloaded instead when ``reuse_cache`` finds shape-matching files.
    """
    sinos = np.clip(np.asarray(x_train_sinograms[:truncate_dataset], np.float32), 0.0, None)
    n = sinos.shape[0]

    if save_path is not None and reuse_cache:
        mp = os.path.join(save_path, "all_masks.npy")
        pp = os.path.join(save_path, "all_proj_samples.npy")
        if os.path.exists(mp) and os.path.exists(pp):
            all_masks, all_proj_samples = np.load(mp), np.load(pp)
            if all_proj_samples.shape == sinos.shape:
                return all_masks, all_proj_samples

    all_masks = make_masks(n, num_angles, num_sparse_angles, random, toy_masks, seed)
    proj_masked = sinos * all_masks[:, :, None]
    if real_data:
        all_proj_samples = proj_masked
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        rate = torch.from_numpy(proj_masked).to(device)
        all_proj_samples = (
            poisson_measurements(rate, poisson_noise_multiplier, gen).cpu().numpy()
        )

    if save_path is not None:
        os.makedirs(save_path, exist_ok=True)
        np.save(os.path.join(save_path, "all_masks.npy"), all_masks)
        np.save(os.path.join(save_path, "all_proj_samples.npy"), all_proj_samples)
    return all_masks, all_proj_samples
