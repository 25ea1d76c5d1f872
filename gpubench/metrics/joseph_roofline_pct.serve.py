"""Kernels A-D of a serve cell against their roofline bound, % (see _common.joseph_roofline)."""

from gpubench.metrics._common import joseph_roofline


def read(run):
    return joseph_roofline(run) if run.kind == "serve" else None
