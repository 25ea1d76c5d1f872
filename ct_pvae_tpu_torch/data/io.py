"""On-disk dataset contract (port of ``ct_pvae_tpu/data/io.py``).

  <ds>/x_train_sinograms.npy       (N, A, P) float
  <ds>/dataset_parameters.npy      object array [theta, num_proj_pix]
  <ds>/x_size.npy, y_size.npy      original image sizes
  <prefix>_training.npy            (N, H, W) ground truth

The same names, dtypes and pickled parameter layout as the JAX package's
(io.py:23-63), so either package reads what the other writes.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def create_folder(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def save_dataset(save_path: str, sinograms: np.ndarray, theta: np.ndarray, x_size: int,
                 y_size: int) -> None:
    create_folder(save_path)
    np.save(os.path.join(save_path, "x_train_sinograms.npy"), sinograms)
    np.save(
        os.path.join(save_path, "dataset_parameters.npy"),
        np.array([theta, sinograms.shape[-1]], dtype=object),
    )
    np.save(os.path.join(save_path, "x_size.npy"), x_size)
    np.save(os.path.join(save_path, "y_size.npy"), y_size)


def load_dataset(input_path: str) -> Tuple[np.ndarray, np.ndarray, int]:
    """(sinograms, theta, num_proj_pix), as ``io.py:38-46``.

    ``dataset_parameters.npy`` is a pickled object array written by the
    repository's own ``make-data``; hence ``allow_pickle=True``.
    """
    theta, num_proj_pix = np.load(
        os.path.join(input_path, "dataset_parameters.npy"), allow_pickle=True
    )
    sinos = np.load(os.path.join(input_path, "x_train_sinograms.npy"))
    return sinos, np.asarray(theta, np.float32), int(num_proj_pix)


def save_ground_truth(images: np.ndarray, img_type: str, root: str = ".") -> str:
    path = os.path.join(root, f"{img_type}_training.npy")
    np.save(path, images)
    return path


def load_ground_truth(input_path: str) -> np.ndarray:
    """'<root>/dataset_<name>' -> '<root>/<name>_training.npy' (the folder's
    own name when it has no ``dataset_`` prefix)."""
    norm = os.path.normpath(input_path)
    base = os.path.basename(norm)
    name = base[len("dataset_"):] if base.startswith("dataset_") else base
    return np.load(os.path.join(os.path.dirname(norm), f"{name}_training.npy"))
