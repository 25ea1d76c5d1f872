"""One run of one cell: set-up, the measured window, the check, the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:

  * its configuration file (``configs``), whose ``reference`` names the
    plain reference ``gpubench/reference/<reference>.py`` and whose
    ``dataset`` names the source of its objects and sinograms
    ``gpubench/datasets/<dataset>.py`` (a function ``make``);
  * its traffic file ``gpubench/traffic/<traffic>.json``, whose ``driver``
    names the driver of the window ``gpubench/drivers/<driver>.py`` (a class
    ``Loop``) and whose ``weights`` names the source of the weights
    ``gpubench/weights/<weights>.py`` (a function ``make``);
  * its limits ``gpubench/limits/<workload>.json``;
  * each per-layer metric's reader ``gpubench/metrics/<metric>.py`` (a
    function ``read(run)`` that returns the value, or None where the run has
    nothing to read).

Adding a cell, a mix, a driver, a configuration or a metric adds files and
entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch

from .profiling import Tracer

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_bench(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench: Dict, workload: str, root: str = ROOT) -> Tuple[Dict, Dict, Dict, Dict]:
    """(workload entry, configuration, traffic, limits) of the cell ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(os.path.join(root, entry["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    limits = load_json(os.path.join(HERE, "limits", workload + ".json"))
    return cell, cfg, traffic, limits


def _module(package: str, name: str):
    """``gpubench.<package>.<name>``, a module found by a name from a data file."""
    if not name.isidentifier():
        raise ValueError(f"{name!r} is not a module name of gpubench/{package}")
    return importlib.import_module(f"gpubench.{package}.{name}")


def driver(name: str):
    """The ``Loop`` of ``gpubench/drivers/<name>.py``."""
    return _module("drivers", name).Loop


def reference(cfg: Dict):
    """The plain reference module that the configuration ``cfg`` names."""
    return _module("reference", cfg["reference"])


def dataset(cfg: Dict):
    """``make(cfg, seed, device)`` of the configuration's dataset source."""
    return _module("datasets", cfg["dataset"]).make


def weights(traffic: Dict):
    """``make(ref, sizes, cfg, seed, device)`` of the traffic's weights source."""
    return _module("weights", traffic["weights"]).make


def metric_reader(name: str):
    """``read`` of ``gpubench/metrics/<name>.py``, loaded from its path."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("gpubench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict, workload: str, trace: bool):
    """The end-to-end (trace False) or per-layer (trace True) metrics this cell reports."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(bench: Dict, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, overrides: Optional[Dict] = None) -> Dict:
    """One run of ``workload``; returns the result line's object (``checks`` last).
    ``t0``: the process's start on the ``time.perf_counter`` clock.
    ``overrides``: {"config": {...}, "traffic": {...}} on top of the files (tests)."""
    _, cfg, traffic, limits = find_cell(bench, workload)
    overrides = overrides or {}
    cfg = dict(cfg, **overrides.get("config", {}))
    traffic = dict(traffic, **overrides.get("traffic", {}))
    loop = driver(traffic["driver"])(cfg, traffic, seed, device)
    setup_s = time.perf_counter() - t0
    stages = " ".join(f"{k} {v:.3f}" for k, v in loop.phases.seconds.items())
    print(f"setup_s {setup_s:.3f}: before the driver {setup_s - sum(loop.phases.seconds.values()):.3f}"
          f" {stages}", file=sys.stderr, flush=True)
    tracer = Tracer(float(traffic["trace_after_s"]), int(traffic["trace_units"])) if trace else None
    window = loop.window(seconds, tracer)
    gpu = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if gpu else 0
    summary = tracer.summary() if tracer is not None else None
    run = SimpleNamespace(kind=traffic["driver"], loop=loop, window=window, trace=summary,
                          device=device,
                          net_seconds=window["seconds"] - (tracer.overhead_s if tracer else 0.0))
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        if m["name"] == "setup_s":
            value = setup_s
        elif m["name"] in window["values"]:
            value = window["values"][m["name"]]
        else:
            value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    numbers = loop.check()
    loop.close()
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and window["failed"] == 0
    dev = {"platform": "gpu" if gpu else device.type,
           "kind": torch.cuda.get_device_name(device) if gpu else device.type,
           "count": 1, "memory_peak_bytes": int(peak),
           "power": power_limit() if gpu else "not measured"}
    result = {"correct": bool(correct), "attempted": int(window["units"]),
              "failed": int(window["failed"]), "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in summary["device_ops"]],
                               "idle_gaps": [list(x) for x in summary["idle_gaps"]]}
    result["checks"] = checks
    return result
