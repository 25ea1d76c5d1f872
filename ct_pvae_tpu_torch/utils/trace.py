"""Spans: named stretches of the port's host code, timed always and recorded
only while a ``torch.profiler`` trace runs.

``span(name)`` is a context manager that reads ``time.perf_counter_ns()`` at
entry and exit; ``s.seconds`` is the stretch's length (``amortized_infer``'s
``timing`` comes from it).  Where a ``torch.profiler`` trace is running at
entry (``torch.autograd._profiler_enabled()``, checked once), the span also
enters ``torch.profiler.record_function(name)``, so that it sits in the same
Chrome trace as the kernels, on the device trace's clock, as a
``user_annotation`` event; and on exit it appends ``Span(name, start_ns,
end_ns)`` to a bounded in-memory list, which ``spans()`` returns and
``clear()`` empties.  With no trace running a span costs two clock reads
and one flag check.

Spans nest as the code nests, on the thread that runs it: a span's
enclosing spans are those whose stretch holds its own (the Chrome trace
shows the same nesting).  The port's spans (all named ``ctpvae.*``) and the
metrics that read them are listed in PERF.md.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, List, NamedTuple

import torch

MAX_SPANS = 65536  # the most recorded spans kept; older ones leave the list first


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_records: Deque[Span] = deque(maxlen=MAX_SPANS)


class span:
    """``with span("ctpvae.setup") as s: ...``; then ``s.seconds``."""

    __slots__ = ("name", "start_ns", "end_ns", "_fn")

    def __init__(self, name: str):
        self.name = name
        self.start_ns = self.end_ns = 0
        self._fn = None

    def __enter__(self) -> "span":
        if torch.autograd._profiler_enabled():
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._fn is not None:
            _records.append(Span(self.name, self.start_ns, self.end_ns))
            self._fn.__exit__(*exc)
            self._fn = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def spans() -> List[Span]:
    """The recorded spans, in the order they ended."""
    return list(_records)


def clear() -> None:
    """Forget the recorded spans."""
    _records.clear()
