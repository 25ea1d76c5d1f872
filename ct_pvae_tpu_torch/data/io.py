"""On-disk dataset contract (port of ``ct_pvae_tpu/data/io.py``).

  <ds>/x_train_sinograms.npy       (N, A, P) float
  <ds>/dataset_parameters.npy      object array [theta, num_proj_pix]
  <prefix>_training.npy            (N, H, W) ground truth
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


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
