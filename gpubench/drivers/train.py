"""Driver ``train``: the paper's training loop in its steady state.

As ``Trainer.train`` runs it: chunks of ``steps_per_call`` steps through
``Trainer.train_chunk`` (each step a replay of the captured step graph on
the card), the batch and angle indices from the loop's two ``IndexStream``s
(seeds seed + 1 and seed + 2), and one device-to-host read of the metric
rows each time ``flush_every`` or more steps have run.  Both numbers come
from the traffic file and are handed to the port's ``Config`` too.  Set-up
builds the ``Trainer`` on the benchmark's sinograms, loads the cell's weights
(the traffic file's ``weights`` source) and drives the first
``check_steps`` steps through ``train_chunk`` (one step, then the rest),
keeping the losses, Adam's first moment after step 1 and the parameters
after the last; then ``warm_chunks`` chunks.  The window runs whole chunks
until ``--seconds`` have passed and ends with the last flush.  A unit of
the window is a chunk.

``check`` frees the program and runs the configuration's plain reference
over the checked steps.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from gpubench import compare, harness
from gpubench.counts import train_step_flops
from gpubench.drivers._common import Phases, annotate, free, port_config


class Loop:
    end_to_end = "train_steps_per_s"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: torch.device):
        from ct_pvae_tpu_torch.device import exact_f32
        from ct_pvae_tpu_torch.utils.batching import IndexStream
        from ct_pvae_tpu_torch.vi.train import Trainer

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
        self.spc = int(traffic["steps_per_call"])
        self.flush_every = int(traffic["flush_every"])
        pcfg = port_config(cfg, train=True, save_path=None, seed=seed, steps_per_call=self.spc,
                           metrics_every=self.flush_every)
        self.trainer = Trainer(pcfg, self.sinos, self.theta, device=device)
        tr = self.trainer
        with torch.no_grad():
            for name in ("encoder", "decoder"):
                for i, blk in enumerate(getattr(tr, name).blocks):
                    blk.weight.copy_(self.weights[name][2 * i])
                    blk.bias.copy_(self.weights[name][2 * i + 1])
        self.batches = IndexStream(tr.num_examples, pcfg.batch_size, pcfg.seed + 1)
        self.angles = IndexStream(tr.num_angles, tr.angles_per_step, pcfg.seed + 2)
        self.phases.mark("program")
        # the checked steps: one step (the capture and a replay), then the rest
        k = int(traffic["check_steps"])
        mu_of = {id(s.param): s.mu for s in tr.slots}
        params = [p for m in (tr.encoder, tr.decoder) for blk in m.blocks
                  for p in (blk.weight, blk.bias)]
        rows = [self._chunk(1)]
        self.program_mu = [mu_of[id(p)].detach().clone() for p in params]
        rows.append(self._chunk(k - 1))
        self.program_params = [p.detach().clone() for p in params]
        self.program_losses = torch.cat(rows)[:, 0].cpu().tolist()
        # what set-up made of the checked steps' rows
        stream = self.ref.IndexStream(tr.num_examples, pcfg.batch_size, pcfg.seed + 1)
        self.rows = np.unique(np.concatenate([stream.next() for _ in range(k)]))
        self.program_stack = tr.data["input_encode"][torch.as_tensor(self.rows, device=device)].cpu()
        self.program_masks = np.asarray(tr.all_masks)[self.rows]
        self.program_proj = np.asarray(tr.all_proj_samples)[self.rows]
        self.steps_before = k
        self.phases.mark("checked_steps")
        for _ in range(int(traffic["warm_chunks"])):
            self._chunk(self.spc)
        self._flush([self._chunk(self.spc)])
        self.phases.mark("warm_up")

    def _chunk(self, k: int) -> torch.Tensor:
        with annotate("gpubench.chunk"):
            return self.trainer.train_chunk([self.batches.next() for _ in range(k)],
                                            [self.angles.next() for _ in range(k)])

    def _flush(self, rows: List[torch.Tensor]) -> int:
        """One device-to-host read of the rows; returns the NaN losses among them."""
        with annotate("gpubench.flush"):
            block = torch.cat(rows).cpu().numpy()
        return int(np.isnan(block[:, 0]).sum())

    def window(self, seconds: float, tracer=None) -> Dict:
        rows, buf, steps, nan = [], 0, 0, 0
        chunks = 0
        start = time.perf_counter()
        while True:
            if tracer is not None:
                tracer.tick(chunks, time.perf_counter() - start)
            rows.append(self._chunk(self.spc))
            buf += self.spc
            steps += self.spc
            chunks += 1
            if buf >= self.flush_every:
                nan += self._flush(rows)
                rows, buf = [], 0
            if time.perf_counter() - start >= seconds:
                break
        if rows:
            nan += self._flush(rows)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        if tracer is not None:
            tracer.finish(chunks)
        return {"seconds": elapsed, "units": steps, "failed": nan,
                "values": {self.end_to_end: steps / elapsed}}

    def close(self) -> None:
        self.trainer = None

    def joseph_uses(self, units: int) -> Dict[str, list]:
        """The Joseph applications of ``units`` chunks, by kernel: each step
        projects its batch times samples images at the step's angles (A) and
        takes the adjoint of the same (B)."""
        api = min(self.cfg["angles_per_iter"], self.cfg["num_angles"])
        use = (units * self.spc, self.cfg["num_samples"] * self.cfg["batch_size"], self.sizes.x,
               api, self.sizes.n_det)
        return {"joseph_fwd_static": [use], "joseph_adj_static": [use]}

    def step_flops(self) -> int:
        return train_step_flops(self.sizes, self.cfg["batch_size"], self.cfg["num_samples"])

    def check(self) -> Dict[str, float]:
        """Free the program, run the reference over the checked steps, and
        return each compared number."""
        self.trainer = None
        free()
        got = compare.program_record(self)
        ref = self.ref.train_steps(self.cfg, self.sinos, self.theta, self.weights, self.seed,
                                   self.steps_before, self.device,
                                   program_stack=self.program_stack)
        print(compare.train_detail(got, ref), file=sys.stderr, flush=True)
        return compare.train_numbers(got, ref, self.cfg["algorithms"])
