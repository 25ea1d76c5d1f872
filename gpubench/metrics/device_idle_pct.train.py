"""Share of the traced stretch of a train cell in which nothing ran on the device, %."""

from gpubench.metrics._common import idle_pct


def read(run):
    return idle_pct(run) if run.kind == "train" else None
