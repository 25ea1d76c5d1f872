"""What the readers of the port's spans share (no metric of its own).

The port records its spans (``ct_pvae_tpu_torch/utils/trace.py``, names
``ctpvae.*``) only while a ``torch.profiler`` trace runs, which in a run of
the benchmark is the traced stretch alone: ``trace.spans()`` after the
window holds the spans of the stretch's units.  A reader finds nothing to
read, and returns None, in a run with no trace or of a program that has no
spans.  It also returns None in a run without a card, though the CPU
records the spans as well: ``tests/test_bench_loops.py``'s
``test_serve_cell_on_the_cpu_traced`` holds the metrics of a traced CPU
run to a fixed set.  The guard goes when that set takes these metrics.
"""

from __future__ import annotations

from typing import List, Optional


def recorded(run) -> Optional[List]:
    """The port's spans of the traced stretch, or None where there are none."""
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    if run.device.type != "cuda":  # see the module's docstring
        return None
    try:
        from ct_pvae_tpu_torch.utils.trace import spans
    except ImportError:
        return None
    return spans() or None


def seconds(spans: List, *names: str) -> float:
    """The spans named ``names``, their lengths summed."""
    return sum(s.seconds for s in spans if s.name in names)


def share_pct(run, kind: str, *names: str) -> Optional[float]:
    """Time in the spans ``names`` over the traced stretch, %, in a ``kind`` cell."""
    spans = recorded(run) if run.kind == kind else None
    if spans is None:
        return None
    return 100.0 * seconds(spans, *names) / run.trace["window_s"]
