"""Readings that the limits of ``gpubench/limits/<workload>.json`` are set from.

    python3 gpubench/calibrate.py --workload <name> --seeds S1,S2,... \
        [--control-seeds C1,C2,C3] [--fault-seeds F1,F2,F3] [--out FILE]

For each ``--seeds`` seed, the program's numbers as a run's check reads
them (training: set-up and the checked steps, no window; serving: set-up,
``--requests`` requests, all of them checked).  For each
``--control-seeds`` seed, the control's: the reference computed with
TF32-rounded convolution operands put in the program's place, against the
reference.  For each ``--fault-seeds`` seed (training), the planted fault
"half of the batch left out, the mean over the rest", in the reference put
in the program's place.  Prints one JSON object (also written to ``--out``).
Needs a CUDA device, as a run does (the tests call its functions on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cell(workload: str, overrides: Optional[Dict]):
    from gpubench import harness

    bench = harness.load_bench()
    _, cfg, traffic, limits = harness.find_cell(bench, workload)
    overrides = overrides or {}
    return (dict(cfg, **overrides.get("config", {})), dict(traffic, **overrides.get("traffic", {})),
            limits)


def program_readings(workload: str, seed: int, device: torch.device, requests: int = 3,
                     overrides: Optional[Dict] = None) -> Dict[str, float]:
    """The program's compared numbers on ``seed`` (no measured window in
    training; ``requests`` requests, each checked, in serving)."""
    from gpubench import harness

    cfg, traffic, _ = _cell(workload, overrides)
    if traffic["driver"] == "serve":
        traffic = dict(traffic, check_requests=requests)
    loop = harness.driver(traffic["driver"])(cfg, traffic, seed, device)
    if traffic["driver"] == "serve":
        for i in range(requests):
            loop.done.append(loop.serve(i))
    numbers = loop.check()
    loop.close()
    return numbers


def reference_readings(workload: str, seed: int, device: torch.device, fault: str = "tf32",
                       overrides: Optional[Dict] = None) -> Dict[str, float]:
    """The numbers of the reference with ``fault`` ("tf32": the control;
    "half_batch") put in the program's place, against the reference."""
    from gpubench import compare, harness, inputs

    cfg, traffic, _ = _cell(workload, overrides)
    pvae = harness.reference(cfg)
    sizes = pvae.model_sizes(cfg)
    sinos, theta = harness.dataset(cfg)(cfg, seed, device)
    weights = harness.weights(traffic)(pvae, sizes, cfg, seed, device)
    if traffic["driver"] == "train":
        k = int(traffic["check_steps"])
        ref = pvae.train_steps(cfg, sinos, theta, weights, seed, k, device)
        got = pvae.train_steps(cfg, sinos, theta, weights, seed, k, device,
                               tf32=fault == "tf32", half_batch=fault == "half_batch")
        return compare.train_numbers(got, ref, cfg["algorithms"])
    rseed = inputs.sub_seed(seed, 12, 1) % (2 ** 31)
    scans = np.sort(np.random.default_rng(rseed).choice(cfg["objects"], int(traffic["scans"]),
                                                        replace=False))
    geometry: Dict = {}
    args = (cfg, sinos[scans], theta, weights, rseed, int(traffic["passes"]), int(cfg["num_iter"]),
            device)
    ref = pvae.serve_request(*args, joseph=geometry)
    got = pvae.serve_request(*args, tf32=True, joseph=geometry)
    return compare.serve_numbers(got, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(
        os.path.abspath(__file__))]
    from ct_pvae_tpu_torch.device import exact_f32

    exact_f32()
    device = torch.device("cuda")
    seeds = lambda text: [int(s) for s in text.split(",") if s]
    out: Dict = {"workload": args.workload, "program": {}, "control": {}, "half_batch": {}}
    for kind, key, fn in (("program", args.seeds, lambda s: program_readings(
            args.workload, s, device, args.requests)),
                          ("control", args.control_seeds, lambda s: reference_readings(
                              args.workload, s, device, "tf32")),
                          ("half_batch", args.fault_seeds, lambda s: reference_readings(
                              args.workload, s, device, "half_batch"))):
        for s in seeds(key):
            t = time.perf_counter()
            out[kind][str(s)] = fn(s)
            print(kind, s, f"{time.perf_counter() - t:.1f} s", json.dumps(out[kind][str(s)]),
                  file=sys.stderr, flush=True)
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
