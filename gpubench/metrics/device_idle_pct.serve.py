"""Share of the traced stretch of a serve cell in which nothing ran on the device, %."""

from gpubench.metrics._common import idle_pct


def read(run):
    return idle_pct(run) if run.kind == "serve" else None
