"""Kernels A-D of a train cell against their roofline bound, % (see _common.joseph_roofline)."""

from gpubench.metrics._common import joseph_roofline


def read(run):
    return joseph_roofline(run) if run.kind == "train" else None
