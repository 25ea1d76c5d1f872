"""Real-data ingest: HDF5 scans -> the sinogram dataset contract (port of
``ct_pvae_tpu/data/real.py``).

Host numpy only, no device work: each ``*.h5`` file under a directory gives
the z slices of its ``exchange/data`` (A, Z, P) projection stack that
``slices`` selects, each optionally scaled to max 1, with the file's
``exchange/theta`` (the reference's scripts/preformat_data_h5.py, and the
JAX package's deviations from it: slice ``n_z // 2`` for "middle" and the
per-sinogram normalisation, real.py:20-45).  ``h5py`` is imported when the
function runs; without it the function raises an ``ImportError`` naming it.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from . import io


def _slice_indices(n_z: int, slices) -> List[int]:
    """The z rows of one (A, Z, P) volume: "middle" (one, ``n_z // 2``),
    "all", or an int count of evenly spaced rows (real.py:20-45)."""
    if slices == "middle":
        return [n_z // 2]
    if slices == "all":
        return list(range(n_z))
    n = int(slices)
    if n <= 0:
        raise ValueError(f"slices={slices!r}: use 'middle', 'all', or a positive int")
    if n >= n_z:
        return list(range(n_z))
    return [round(i * (n_z - 1) / (n - 1)) for i in range(n)] if n > 1 else [n_z // 2]


def preformat_h5(
    input_dir: str,
    save_path: str,
    data_key: str = "exchange/data",
    theta_key: str = "exchange/theta",
    normalize: bool = True,
    slices="middle",
) -> Tuple[np.ndarray, np.ndarray]:
    """(sinograms (N, A, P), theta (A,)) of every selected slice of every
    .h5 file under ``input_dir`` (files sorted, searched recursively; a
    file without both keys or with another angle count than the first is
    skipped; negatives set to 0), written to ``save_path`` in the dataset
    contract (real.py:48-89)."""
    try:
        import h5py
    except ImportError as err:
        raise ImportError("real-data ingest (make-data --h5-dir) needs the h5py package, "
                          "which is not installed") from err

    files = sorted(glob.glob(os.path.join(input_dir, "**", "*.h5"), recursive=True))
    if not files:
        raise FileNotFoundError(f"no .h5 files under {input_dir}")
    sinos: List[np.ndarray] = []
    theta_ref: Optional[np.ndarray] = None
    for path in files:
        with h5py.File(path, "r") as f:
            if data_key not in f or theta_key not in f:
                continue
            data = f[data_key]
            theta = np.asarray(f[theta_key][...], np.float32).reshape(-1)
            if theta_ref is None:
                theta_ref = theta
            elif len(theta) != len(theta_ref):
                continue
            for z in _slice_indices(data.shape[1], slices):
                sino = np.asarray(data[:, z, :], np.float32)
                if normalize and sino.max() > 0:
                    sino = sino / sino.max()
                sinos.append(sino)
    if not sinos:
        raise ValueError("no usable (data, theta) pairs found")
    arr = np.stack(sinos, axis=0)
    arr[arr < 0] = 0
    io.save_dataset(save_path, arr, theta_ref, arr.shape[-1], arr.shape[-1])
    return arr, theta_ref
