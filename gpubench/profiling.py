"""The traced stretch of a ``--trace 1`` window and what its device timeline says.

``Tracer`` starts ``torch.profiler`` (CPU and CUDA activities) at the first
unit (train chunk or request) that begins ``start_after_s`` into the window,
stops it ``units`` units later, and marks the stretch with a
``gpubench.traced`` annotation.  The time it spends starting and stopping
is ``overhead_s``, which the rates of a traced run leave out.  ``summary``
reads the exported Chrome trace: every kernel, copy and set on the device
inside the stretch, their union (``busy_s``), the stretch's length
(``window_s``), time by operation, the idle gaps labelled by the innermost
host event around each gap's middle, launches by kernel name, and the
number of units traced (``units``).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")
MARK = "gpubench.traced"


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Tracer:
    def __init__(self, start_after_s: float, units: int):
        self.start_after_s, self.units = start_after_s, units
        self.prof = None
        self.mark = None
        self.first_unit: Optional[int] = None
        self.done = False
        self.traced_units = 0
        self.overhead_s = 0.0

    def tick(self, unit: int, elapsed: float) -> None:
        """Called before each unit of the window with its index and the time so far."""
        if self.done:
            return
        if self.prof is None and elapsed >= self.start_after_s:
            t = time.perf_counter()
            _sync()
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                             else [])
            self.prof = profile(activities=acts)
            self.prof.start()
            self.mark = torch.profiler.record_function(MARK)
            self.mark.__enter__()
            self.first_unit = unit
            self.overhead_s += time.perf_counter() - t
        elif self.prof is not None and unit - self.first_unit >= self.units:
            self._stop(unit)

    def _stop(self, unit: int) -> None:
        self.traced_units = unit - self.first_unit
        _sync()
        t = time.perf_counter()
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.done = True
        self.overhead_s += time.perf_counter() - t

    def finish(self, units: int) -> None:
        """End of the window, after ``units`` units: stop a stretch still
        running (after the window's clock, so its cost is not the window's)."""
        if self.prof is not None and not self.done:
            inside = self.overhead_s
            self._stop(units)
            self.overhead_s = inside

    def summary(self) -> Optional[Dict]:
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json", prefix="gpubench-trace-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return dict(summarise(events), units=self.traced_units)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(a, b) for a, b in out]


def summarise(events: List[Dict]) -> Dict:
    """Busy and window seconds, top device operations, idle gaps and launches
    by kernel name of the stretch marked ``MARK`` in a Chrome trace."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in xs if e.get("name") == MARK and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no traced stretch")
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    dev = []
    for e in xs:
        if e.get("cat") in DEVICE_CATS:
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if b > lo and a < hi:
                dev.append((max(a, lo), min(b, hi), e["name"], float(e["dur"])))
    busy = _merge([(a, b) for a, b, _, _ in dev])
    by_name: Dict[str, float] = defaultdict(float)
    launches: Dict[str, List[float]] = defaultdict(list)
    for _, _, name, dur in dev:
        by_name[name] += dur * 1e-6
        launches[name].append(dur * 1e-6)
    gaps, edge = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > edge:
            gaps.append((a - edge, 0.5 * (edge + a)))
        edge = max(edge, b)
    host = [e for e in xs if e.get("cat") in HOST_CATS and e.get("name") != MARK]
    labelled = []
    for length, mid in sorted(gaps, reverse=True)[:10]:
        around = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        label = min(around, key=lambda e: float(e["dur"]))["name"] if around else "(no host event)"
        labelled.append((label, length * 1e-6))
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": labelled,
        "launches": dict(launches),
    }
