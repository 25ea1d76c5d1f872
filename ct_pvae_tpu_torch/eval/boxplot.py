"""Cross-trial box plots of dataset merit (port of ``ct_pvae_tpu/eval/boxplot.py``).

Aggregates ``final_ave_merit.npy`` over run directories (reference
bin/create_box_plot.py; boxplot.py:1-120).  Two modes:

* 5 conditions, the published figure's protocol, when every random-mask run
  has a ``<run>_uniform`` sibling (or ``uniform_paths`` are given):
  (a) full, (b) partial uniform, (c) partial random, (d) P-VAE uniform,
  (e) P-VAE random, with the reference's median-trial finders;
* 3 conditions otherwise: each run's full / partial / P-VAE rows.

Host numpy only.  ``box_plot_table`` gives the table, its labels and the
printed lines; ``make_box_plots`` also draws ``<metric>_boxplot.png``
(matplotlib, imported there) and writes the printed lines to
``medians.txt``, as the repository's box-plot scripts tee them.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .plots import pyplot

METRIC_NAMES = ["MSE", "SSIM", "PSNR"]

FIVE_CONDITION_LABELS = [
    "(a) full",
    "(b) partial uniform",
    "(c) partial random",
    "(d) P-VAE uniform",
    "(e) P-VAE random",
]
THREE_CONDITION_LABELS = ["full FBP", "partial FBP", "P-VAE"]


def load_merits(save_paths: Sequence[str]) -> np.ndarray:
    """(num_runs, 3 conditions, 3 metrics) of the runs' final_ave_merit."""
    return np.stack([np.load(os.path.join(sp, "final_ave_merit.npy")) for sp in save_paths], axis=0)


def pair_uniform_paths(save_paths: Sequence[str]) -> Optional[List[str]]:
    """The ``<run>_uniform`` sibling of every run, or None if any is missing."""
    pairs = []
    for sp in save_paths:
        up = sp.rstrip("/") + "_uniform"
        if not os.path.exists(os.path.join(up, "final_ave_merit.npy")):
            return None
        pairs.append(up)
    return pairs


def five_condition_table(random_merits: np.ndarray, uniform_merits: np.ndarray) -> np.ndarray:
    """(T, 5, 3) in the reference's column layout (create_box_plot.py:42-47)."""
    final_vals = np.zeros((len(random_merits), 5, 3))
    final_vals[:, 0] = random_merits[:, 0, :]   # full
    final_vals[:, 1] = uniform_merits[:, 1, :]  # partial uniform
    final_vals[:, 2] = random_merits[:, 1, :]   # partial random
    final_vals[:, 3] = uniform_merits[:, 2, :]  # P-VAE uniform
    final_vals[:, 4] = random_merits[:, 2, :]   # P-VAE random
    return final_vals


def median_trials(final_vals: np.ndarray) -> Dict[str, np.ndarray]:
    """For each metric and mask kind, the trials whose P-VAE merit equals the
    median across trials (none for an even count, as the reference's
    finders, create_box_plot.py:49-73)."""
    trials = np.arange(len(final_vals))
    out: Dict[str, np.ndarray] = {}
    for m, name in enumerate(METRIC_NAMES):
        for col, kind in ((4, "random"), (3, "uniform")):
            vals = final_vals[:, col, m]
            out[f"{name}_{kind}"] = trials[vals == np.median(vals)]
    return out


def box_plot_table(save_paths: Sequence[str], uniform_paths: Optional[Sequence[str]] = None
                   ) -> Tuple[np.ndarray, List[str], List[str]]:
    """(table (T, conditions, 3), condition labels, the printed lines: the
    median trials in the 5-condition mode, then each metric's medians)."""
    if uniform_paths is None:
        uniform_paths = pair_uniform_paths(save_paths)
    lines = []
    if uniform_paths is not None:
        if len(uniform_paths) != len(save_paths):
            raise ValueError(f"{len(save_paths)} random runs vs {len(uniform_paths)} uniform runs")
        final_vals = five_condition_table(load_merits(save_paths), load_merits(uniform_paths))
        labels = FIVE_CONDITION_LABELS
        lines += [f"median trial for {key}: {idx}" for key, idx in median_trials(final_vals).items()]
    else:
        final_vals = load_merits(save_paths)
        labels = THREE_CONDITION_LABELS
    for m, name in enumerate(METRIC_NAMES):
        med = np.median(final_vals[:, :, m], axis=0)
        lines.append(f"{name} medians: " + ", ".join(f"{lb}={v:.4g}" for lb, v in zip(labels, med)))
    return final_vals, labels, lines


def make_box_plots(save_paths: Sequence[str], out_dir: str = ".",
                   uniform_paths: Optional[Sequence[str]] = None) -> None:
    """``<metric>_boxplot.png`` for MSE, SSIM and PSNR and ``medians.txt``
    under ``out_dir``; prints the median lines."""
    plt = pyplot()
    final_vals, labels, lines = box_plot_table(save_paths, uniform_paths)
    os.makedirs(out_dir, exist_ok=True)
    for line in lines:
        print(line)
    with open(os.path.join(out_dir, "medians.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for m, name in enumerate(METRIC_NAMES):
        plt.figure()
        plt.title(name)
        plt.boxplot(final_vals[:, :, m], whis=100, tick_labels=labels)
        plt.xticks(rotation=20)
        plt.savefig(os.path.join(out_dir, f"{name}_boxplot.png"), bbox_inches="tight", dpi=300)
        plt.close()
