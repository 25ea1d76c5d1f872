"""Standalone dataset visualiser (port of ``ct_pvae_tpu/eval/dataset_viz.py``).

One example's FULL sinogram, its PARTIAL sinograms under a random-angle and
a uniform-angle mask run, and its ground truth zero-padded to the detector
size (reference bin/visualize_dataset.py:30-52), with the reference's
quirks: the partial sinograms are multiplied by ``num_sparse_angles`` (which
undoes the mask's 1/nsa dose scale) and share the full sinogram's colour
range; borderless, tick-free 300-dpi grayscale PNGs named
``<name>_ex_<N>.png``.  Host numpy only.  ``dataset_panels`` gives the
arrays, ``visualize_dataset`` writes the PNGs (matplotlib, imported there).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..data import io as data_io
from .plots import pyplot

Panel = Tuple[np.ndarray, Optional[float], Optional[float]]  # image, vmin, vmax


def dataset_panels(
    input_path: str,
    save_path_random: Optional[str] = None,
    save_path_uniform: Optional[str] = None,
    example_num: int = 0,
    num_sparse_angles: int = 20,
) -> Dict[str, Panel]:
    """{panel name: (image, vmin, vmax)}; a mask run given as None has no panel."""
    sinos, _theta, num_proj_pix = data_io.load_dataset(input_path)
    full = sinos[example_num]
    panels: Dict[str, Panel] = {"full_sinogram": (full, None, None)}
    vmin, vmax = float(np.min(full)), float(np.max(full))
    for name, run in (("proj_random", save_path_random), ("proj_uniform", save_path_uniform)):
        if run is not None:
            proj = np.load(os.path.join(run, "all_proj_samples.npy"))[example_num]
            panels[name] = (num_sparse_angles * proj, vmin, vmax)
    ground_truth = data_io.load_ground_truth(input_path)[example_num]
    padding = (num_proj_pix - ground_truth.shape[0]) // 2
    panels["ground_truth"] = (np.pad(ground_truth, ((padding, padding), (padding, padding))), None, None)
    return panels


def _plot_panel(plt, img: np.ndarray, out_dir: str, name: str, example_num: int,
                vmin=None, vmax=None) -> str:
    plt.figure(figsize=[10, 10])
    plt.imshow(np.asarray(img), cmap="gray", vmin=vmin, vmax=vmax)
    plt.xticks([])
    plt.yticks([])
    plt.box(False)
    path = os.path.join(out_dir, f"{name}_ex_{example_num}.png")
    plt.savefig(path, bbox_inches="tight", dpi=300, pad_inches=0.0)
    plt.close()
    return path


def visualize_dataset(
    input_path: str,
    save_path_random: Optional[str] = None,
    save_path_uniform: Optional[str] = None,
    example_num: int = 0,
    num_sparse_angles: int = 20,
    out_dir: Optional[str] = None,
) -> Dict[str, str]:
    """Write the panel set; returns {panel name: png path}.  ``out_dir``
    defaults to ``input_path``, where the reference writes."""
    plt = pyplot()
    out_dir = input_path if out_dir is None else out_dir
    os.makedirs(out_dir, exist_ok=True)
    panels = dataset_panels(input_path, save_path_random, save_path_uniform, example_num,
                            num_sparse_angles)
    return {name: _plot_panel(plt, img, out_dir, name, example_num, vmin, vmax)
            for name, (img, vmin, vmax) in panels.items()}
