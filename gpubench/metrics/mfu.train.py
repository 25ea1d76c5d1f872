"""Model FLOPs of the train steps in the window over its seconds, % of the peak.

A step's FLOPs are ``counts.train_step_flops`` (direct convolution, forward
and both gradients); the seconds leave out the profiler's start and stop.
"""

from gpubench.metrics._common import mfu


def read(run):
    if run.kind != "train":
        return None
    return mfu(run.loop.step_flops() * run.window["units"], run.net_seconds)
