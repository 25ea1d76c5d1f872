"""Driver ``serve``: one closed-loop client of ``amortized_infer``.

Each request is one ``amortized_infer`` call (the ``cli infer`` path, no
output files) on ``scans`` scans drawn from the configuration's objects with
the request's own seed, ``passes`` passes per batch over the real init
stack.  Set-up writes the trained run's directory (the weights of the
traffic file's ``weights`` source, as a checkpoint at step ``num_iter``)
under ``TMPDIR`` and serves one request.  The window sends requests back to
back until ``--seconds`` have passed and ends when the last one returns.  A
unit of the window is a request.

``check`` frees the program and runs the configuration's plain reference
over ``check_requests`` finished requests drawn from the seed.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from gpubench import checkpoint, compare, harness, inputs
from gpubench.counts import eval_pass_flops, init_applications
from gpubench.drivers._common import Phases, annotate, free, port_config


class Loop:
    end_to_end = "serve_scans_per_s"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: torch.device):
        from ct_pvae_tpu_torch.device import exact_f32

        exact_f32()
        self.phases = Phases(device)
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.ref = harness.reference(cfg)
        self.sizes = self.ref.model_sizes(cfg)
        self.sinos, self.theta = harness.dataset(cfg)(cfg, seed, device)
        self.weights = harness.weights(traffic)(self.ref, self.sizes, cfg, seed, device)
        free()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        self.phases.mark("inputs")
        self.run_dir = tempfile.mkdtemp(prefix="gpubench-run-")
        fields = port_config(cfg).to_dict()
        fields.update(train=True, save_path=None, input_path=None)
        self.step = int(cfg["num_iter"])
        checkpoint.write_run(self.run_dir, fields, self.sizes, self.weights, self.step)
        self.done: List[Dict] = []
        self.phases.mark("run_dir")
        self.serve(-1)  # the warm-up request
        self.phases.mark("warm_up")

    def request(self, i: int):
        """(seed, scan indices) of request ``i`` (-1: the warm-up)."""
        rseed = inputs.sub_seed(self.seed, 12, i + 1) % (2 ** 31)
        rng = np.random.default_rng(rseed)
        scans = np.sort(rng.choice(self.cfg["objects"], int(self.traffic["scans"]), replace=False))
        return rseed, scans

    def serve(self, i: int) -> Dict:
        from ct_pvae_tpu_torch.vi.infer import amortized_infer

        rseed, scans = self.request(i)
        with annotate("gpubench.request"):
            out = amortized_infer(self.run_dir, None, sinograms=self.sinos[scans], theta=self.theta,
                                  num_passes=int(self.traffic["passes"]), seed=rseed,
                                  device=self.device)
        return out

    def window(self, seconds: float, tracer=None) -> Dict:
        start = time.perf_counter()
        i = 0
        while True:
            if tracer is not None:
                tracer.tick(i, time.perf_counter() - start)
            out = self.serve(i)
            self.done.append(out)
            i += 1
            if time.perf_counter() - start >= seconds:
                break
        elapsed = time.perf_counter() - start
        if tracer is not None:
            tracer.finish(i)
        scans = i * int(self.traffic["scans"])
        bad = sum(int(not np.isfinite(o["mean"]).all()) for o in self.done)
        return {"seconds": elapsed, "units": i, "failed": bad,
                "setup_s": [o["timing"]["setup_s"] for o in self.done],
                "values": {self.end_to_end: scans / elapsed}}

    def joseph_uses(self, units: int) -> Dict[str, list]:
        """The Joseph applications of ``units`` requests, by kernel: every
        pass projects its batch times samples images at all angles (A), and
        each scan's init stack applies the P x P pair as
        ``counts.init_applications`` says (C and D)."""
        scans, b, s = int(self.traffic["scans"]), self.cfg["batch_size"], self.cfg["num_samples"]
        a, p, x = self.cfg["num_angles"], self.sizes.n_det, self.sizes.x
        fwd, adj = init_applications(self.cfg["algorithms"], p)
        return {"joseph_fwd_static": [(units * self.passes_per_request(), b * s, x, a, p),
                                      (units * scans * fwd, 1, p, a, p)],
                "joseph_adj_static": [(units * scans * adj, 1, p, a, p)]}

    def pass_flops(self) -> int:
        return eval_pass_flops(self.sizes, self.cfg["batch_size"], self.cfg["num_samples"])

    def passes_per_request(self) -> int:
        scans, b = int(self.traffic["scans"]), self.cfg["batch_size"]
        return -(-scans // b) * int(self.traffic["passes"])

    def check(self) -> Dict[str, float]:
        """Reference answers of a sample of the finished requests drawn from
        the seed, compared with what the program served."""
        shutil.rmtree(self.run_dir, ignore_errors=True)
        free()
        rng = np.random.default_rng(inputs.sub_seed(self.seed, 13))
        k = min(int(self.traffic["check_requests"]), len(self.done))
        picked = sorted(rng.choice(len(self.done), size=k, replace=False).tolist())
        keep = {i: self.done[i] for i in picked}
        self.done = []
        free()
        geometry: Dict = {}
        readings = []
        for i, got in keep.items():
            rseed, scans = self.request(i)
            ref = self.ref.serve_request(self.cfg, self.sinos[scans], self.theta, self.weights,
                                         rseed, int(self.traffic["passes"]), self.step, self.device,
                                         joseph=geometry)
            readings.append(compare.serve_numbers(got, ref))
        return {k: max(r[k] for r in readings) for k in readings[0]}

    def close(self) -> None:
        shutil.rmtree(self.run_dir, ignore_errors=True)
