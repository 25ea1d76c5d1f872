"""Forward FLOPs of every eval pass of the requests in the window over its seconds, % of the peak."""

from gpubench.metrics._common import mfu


def read(run):
    if run.kind != "serve":
        return None
    passes = run.loop.passes_per_request() * run.window["units"]
    return mfu(run.loop.pass_flops() * passes, run.net_seconds)
