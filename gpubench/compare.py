"""The numbers that decide ``correct``: the program's answers against the reference's.

Training (the first steps of a run, from the same weights, seed and data):

  * ``mask_mismatch``: entries of the checked rows' masks that differ;
  * ``measurement_gap``: the largest difference of their Poisson measurements;
  * ``stack_gap``: the init stack of those rows, each channel's
    ||program - reference|| / ||reference||, the worst channel but tv.  The
    tv channel is not compared: its 60 Chambolle-Pock iterations with the
    paper's step sizes are a chaotic map (sigma tau ||A||^2 is far above 1;
    a change of 1e-6 in the input moves the result by tens of %, and two
    runs of the reference part by as much), and no number of it that was
    tried (the image, its TV objective, its data fit summed over the rows)
    separates a sound tv channel from zeros or from too few iterations.  So
    the reference's steps take the tv channel of the program's stack and
    work every other channel out themselves;
  * ``loss_gap``: each step's |loss - reference| / |reference|, the worst step;
  * ``grad_gap``: the first step's gradient as Adam got it (clipped; the
    program's worked out from its first moment after one step, mu / (1 - b1)),
    per optimiser leaf | ||g|| - ||g_ref|| | over the larger of ||g_ref|| and the
    median leaf's, the worst leaf;
  * ``update_gap``: the parameters' change over the checked steps, per leaf
    as ``grad_gap``, over the leaves whose reference gradient is at least a
    thousandth of the median leaf's (a leaf below that moves by round-off
    alone under Adam).

Serving (a sample of the requests the window finished): each scan's
||program - reference|| / ||reference|| of the posterior mean and std maps
(``mean_gap``, ``std_gap``, the worst scan) and each batch's relative loss
gap (``loss_gap``).  The sample map is not compared: it is an inverse-CDF
draw whose tail pixels move with the smallest change of the output's loc
and scale, so sound runs and the TF32 control read alike on it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _leaf_gaps(got: List[torch.Tensor], ref: List[torch.Tensor], counted: List[bool]) -> np.ndarray:
    """Per leaf | ||g|| - ||r|| | / max(||r||, the counted leaves' median ||r||); NaN where not counted."""
    g = np.array([float(torch.linalg.vector_norm(t.double())) for t in got])
    r = np.array([float(torch.linalg.vector_norm(t.double())) for t in ref])
    c = np.asarray(counted)
    gaps = np.abs(g - r) / np.maximum(r, np.median(r[c]))
    return np.where(c, gaps, np.nan)


def _norm_gaps(got: List[torch.Tensor], ref: List[torch.Tensor], counted: List[bool]) -> float:
    return float(np.nanmax(_leaf_gaps(got, ref, counted)))


def program_record(loop):
    """The program's side of the checked steps as the reference's ``TrainRecord``."""
    ref = loop.ref
    blocks = [b for b in loop.sizes.encoder + loop.sizes.decoder for _ in (0, 1)]
    split = lambda ts: [h for i, t in enumerate(ts)
                        for h in ref.leaves(blocks[i], "weight" if i % 2 == 0 else "bias", t)]
    start = loop.weights["encoder"] + loop.weights["decoder"]
    return ref.TrainRecord(loop.program_losses, split([m / (1 - ref.B1) for m in loop.program_mu]),
                       split([p - p0 for p, p0 in zip(loop.program_params, start)]),
                       loop.program_stack, loop.rows, loop.program_masks,
                       torch.as_tensor(loop.program_proj))


def train_numbers(got, ref, algorithms: List[str]) -> Dict[str, float]:
    if not np.array_equal(got.rows, ref.rows):
        raise RuntimeError("the checked rows of the two sides differ")
    ref_norms = np.array([float(torch.linalg.vector_norm(g.double())) for g in ref.grads])
    moved = list(ref_norms >= 1e-3 * np.median(ref_norms))
    stack_p = got.stack.double().cpu().numpy()
    stack_r = ref.stack.double().cpu().numpy()
    names = list(algorithms) + ["mask"]
    return {
        "mask_mismatch": float(np.sum(got.masks != ref.masks)),
        "measurement_gap": float(torch.max(torch.abs(got.proj.cpu() - ref.proj.cpu()))),
        "stack_gap": max(_rel(stack_p[..., c], stack_r[..., c])
                         for c, name in enumerate(names) if name != "tv"),
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got.losses, ref.losses)),
        "grad_gap": _norm_gaps(got.grads, ref.grads, [True] * len(ref.grads)),
        "update_gap": _norm_gaps(got.change, ref.change, moved),
    }


def train_detail(got, ref) -> str:
    """One line for standard error: each step's loss gap, and the three
    leaves with the widest gradient and change gaps (index: gap)."""
    ref_norms = np.array([float(torch.linalg.vector_norm(g.double())) for g in ref.grads])
    moved = list(ref_norms >= 1e-3 * np.median(ref_norms))
    grads = _leaf_gaps(got.grads, ref.grads, [True] * len(ref.grads))
    change = _leaf_gaps(got.change, ref.change, moved)
    top = lambda gaps: ", ".join(f"{i}: {gaps[i]:.3g}"
                                 for i in np.argsort(-np.nan_to_num(gaps, nan=-1.0))[:3])
    steps = ", ".join(f"{abs(a - b) / abs(b):.3g}" for a, b in zip(got.losses, ref.losses))
    return (f"loss gaps by step {steps}; widest grad leaves {top(grads)}; widest change leaves "
            f"{top(change)} of {len(moved)}")


def serve_numbers(got: Dict, ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    n = ref["mean"].shape[0]
    got = {k: np.asarray(v).reshape(ref[k].shape) for k, v in got.items() if k in ref}
    per_scan = lambda key: max(_rel(got[key][i], ref[key][i]) for i in range(n))
    loss = np.asarray(got["loss"], np.float64)
    return {
        "mean_gap": per_scan("mean"),
        "std_gap": per_scan("std"),
        "loss_gap": float(np.max(np.abs(loss - ref["loss"]) / np.abs(ref["loss"]))),
    }
