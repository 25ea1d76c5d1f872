"""Shared arithmetic of the per-layer readers (no metric of its own)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from gpubench.counts import PEAK_FLOPS, joseph_bound

JOSEPH = ("joseph_fwd_static_kernel", "joseph_adj_static_kernel")


def mfu(flops: float, seconds: float) -> float:
    return 100.0 * flops / seconds / PEAK_FLOPS


def idle_pct(run) -> Optional[float]:
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def joseph_roofline(run) -> Optional[float]:
    """The roofline bound of the Joseph work that the traced units needed
    (the driver's ``joseph_uses``, per kernel) over the device time of that
    kernel's launches in the stretch, in %, over the kernels that ran there."""
    if not run.trace or not run.trace["units"]:
        return None
    uses = run.loop.joseph_uses(run.trace["units"])
    bound = spent = 0.0
    for kernel in JOSEPH:
        durs = [d for name, ds in run.trace["launches"].items() if kernel in name for d in ds]
        if durs:
            bound += joseph_bound(uses.get(kernel.replace("_kernel", ""), []), run.loop.theta,
                                  run.device)
            spent += float(np.sum(durs))
    return 100.0 * bound / spent if spent > 0 else None
