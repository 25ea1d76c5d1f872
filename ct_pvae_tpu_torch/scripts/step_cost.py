"""What the projector route costs the serve and train steps, on one GPU.

    python ct_pvae_tpu_torch/scripts/step_cost.py [--tree DIR] [--steps 20]

Builds a ``Trainer`` for the foam paper run (``results/foam_paper_run_r4``:
its config and weights) on the first batch of ``dataset_foam`` with the
cheap init stack, then measures, on the card:

  route  the projector's forward and backward as the train step calls it:
         ``Trainer.project`` on the step's 20 angles (an ``index_select``,
         ``radon_fused``'s autograd Function) and ``backward``; device ms
         and host us per call, with the host held out of the device time
         (``cuda_time``), in turns with A's and B's first designs
         (``csrc/joseph_fwd.cu``, ``csrc/joseph_adj.cu``) swapped in on the
         same angles (``route_in_turns``)
  eval   ``Server.eval_step`` at batch 10 over all 180 angles, drawing
         inside the step from a generator as ``amortized_infer`` does
  train  ``Trainer.train_step`` at batch 10, 20 angles, 2 ELBO samples, as
         ``Trainer.train`` runs its eager steps: host indices, the step's
         own draws
  train_graphed  the same step as replays of its CUDA graph: ``train_chunk``
         of ``steps_per_call`` (8) steps a call, every number per step
         (where the tree has it)
  setup  the set-up of ``cli infer`` without ``--cheap_init`` on the first
         100 sinograms (masks, Poisson draws, the sirt/tv/fbp/gridrec init
         stack on kernels C and D, restore): ``amortized_infer``'s
         ``setup_s``, three times after one warm-up

each step's unprofiled wall ms, its device-busy ms by torch.profiler, and
its device ms and host ms with the host held out (``cuda_time``); then each
step's wall in turns, three times, with the tree's projector and with the
first designs swapped in, since the walls move with the host from process
to process more than the projector can move them.
It prints one JSON line.  ``--tree`` names the checkout whose
``ct_pvae_tpu_torch`` is measured (default: the one holding this script),
so one call can measure two commits in turns from the same data; the data
and the weights always come from the checkout holding this script.  It
needs a CUDA GPU and exits 1 without one.

``cuda_time`` is also ``chip_smoke.py``'s kernel timer.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from functools import lru_cache
from typing import Callable, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MAX_SPIN_US = 200_000.0
SETUP_SCANS = 100  # the serve-real cell's scans (chip_smoke.py phase 7)


@lru_cache(maxsize=None)
def _spin_rate() -> float:
    """Cycles per microsecond of ``torch.cuda._sleep`` on this card, measured once."""
    import torch

    cycles = 2_000_000
    torch.cuda._sleep(cycles)  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / (start.elapsed_time(end) * 1e3)


def cuda_time(fn: Callable[[], object], repeats: int, per_sample: int = 1) -> Tuple[float, float, bool]:
    """(device ms, host us, covered) per call of ``fn()``: medians over
    ``repeats`` samples of ``per_sample`` calls queued between two CUDA
    events, after one warm-up call.  Before each sample a spin kernel
    (``torch.cuda._sleep``) holds the device for longer than the host takes
    to enqueue the sample, so the events bracket device time only; the
    host's time is the enqueue loop's wall time.  A sample whose enqueue
    outlasted its spin is taken again with a spin 4x as long, up to 3 times
    and up to MAX_SPIN_US; if it still does not fit (a host that waits on
    the device, as when its launch queue is full), ``covered`` is False,
    the rest are taken once each, and their device time holds host time
    too."""
    import torch

    rate = _spin_rate()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(per_sample):
        fn()
    spin_us = min(1.5 * (time.perf_counter() - t0) * 1e6 + 50.0, MAX_SPIN_US)
    torch.cuda.synchronize()
    dev, host, covered = [], [], True
    for _ in range(repeats):
        for _attempt in range(4 if covered else 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t_spin = time.perf_counter()
            torch.cuda._sleep(int(spin_us * rate))
            start.record()
            t0 = time.perf_counter()
            for _ in range(per_sample):
                fn()
            t1 = time.perf_counter()
            end.record()
            end.synchronize()
            if (t1 - t_spin) * 1e6 < 0.8 * spin_us or not covered:
                break
            spin_us = min(4 * spin_us, MAX_SPIN_US)
        else:
            covered = False
        dev.append(start.elapsed_time(end) / per_sample)
        host.append((t1 - t0) * 1e6 / per_sample)
    dev.sort()
    host.sort()
    return dev[len(dev) // 2], host[len(host) // 2], covered


def _wall(step: Callable[[], object], steps: int) -> float:
    """Unprofiled wall ms per step: ``steps`` steps after two warm-up steps,
    timed by the host clock to a synchronise."""
    import torch

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def _wall_and_busy(step: Callable[[], object], steps: int) -> Tuple[float, float]:
    """(unprofiled wall ms, device-busy ms) per step: ``_wall``, then
    ``steps`` more steps under torch.profiler, whose device-side entries
    (kernels, copies) are summed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall_ms = _wall(step, steps)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU and e.self_device_time_total > 0)
    return wall_ms, busy_us / steps / 1e3


def _swap_in_first_designs(joseph_radon, cuda) -> Callable[[], None]:
    """Route the tree's ``radon_fused`` forward and backward through A's and
    B's first designs on the same angles: an (A, 5) table as it is, (A, 8)
    kernel rows through a copy of their first five columns (one more small
    launch each way); returns the function that restores the tree's own."""
    fwd, adj = joseph_radon._forward, joseph_radon._adjoint
    table = lambda t: t if t.shape[1] == 5 else t[:, :5].contiguous()
    joseph_radon._forward = lambda image, t, n_det: cuda.joseph_fwd(image, table(t), n_det)
    joseph_radon._adjoint = lambda sino, t, n: cuda.joseph_adj(sino, table(t), n)

    def restore() -> None:
        joseph_radon._forward, joseph_radon._adjoint = fwd, adj

    return restore


def route_in_turns(own: Callable[[], object], first: Callable[[], object], joseph_radon, cuda,
                   turns: int = 2) -> List[dict]:
    """``own()`` (a ``radon_fused`` forward and backward on the tree's
    kernels) and ``first()`` (the same route, run with A's and B's first
    designs swapped in), in turns, ``turns`` times each: device ms, host us
    and ``covered`` per call, by ``cuda_time`` (10 samples of 20 calls)."""
    out = []
    for k in range(2 * turns):
        projector = "first_designs" if k % 2 else "own"
        restore = _swap_in_first_designs(joseph_radon, cuda) if k % 2 else (lambda: None)
        try:
            dev_ms, host_us, covered = cuda_time(first if k % 2 else own, 10, per_sample=20)
        finally:
            restore()
        out.append({"projector": projector, "device_ms": dev_ms, "host_us": host_us,
                    "covered": covered})
    return out


def _setup_s(run: str, data: str, out: str, dev, reps: int = 3) -> List[float]:
    """``amortized_infer``'s set-up seconds on the init stack (no cheap
    init), as ``cli infer`` without ``--cheap_init`` runs it: ``reps``
    times after one warm-up, each into a fresh output directory."""
    from ct_pvae_tpu_torch.vi.infer import amortized_infer

    times = []
    for k in range(reps + 1):
        res = amortized_infer(run, os.path.join(out, f"setup_{k}"), input_path=data, num_passes=1,
                              device=dev)
        times.append(res["timing"]["setup_s"])
    return times[1:]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT, help="checkout whose ct_pvae_tpu_torch is measured")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("step_cost: torch.cuda.is_available() is False; this needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.tree))
    import ct_pvae_tpu_torch
    from ct_pvae_tpu_torch.config import Config
    from ct_pvae_tpu_torch.data.io import load_dataset
    from ct_pvae_tpu_torch.device import exact_f32
    from ct_pvae_tpu_torch.ops import _cuda, joseph_radon
    from ct_pvae_tpu_torch.vi.train import Trainer

    exact_f32()
    dev = torch.device("cuda")
    r4 = os.path.join(ROOT, "results", "foam_paper_run_r4")
    cfg = Config.load(os.path.join(r4, "config.json"))
    sinos_all, theta, _ = load_dataset(os.path.join(ROOT, "dataset_foam"))
    sinos = sinos_all[: cfg.batch_size]
    with tempfile.TemporaryDirectory(prefix="step_cost_") as tmp:
        os.makedirs(os.path.join(tmp, "training_checkpoints"))
        os.symlink(os.path.join(r4, "ckpt-100000.msgpack"),
                   os.path.join(tmp, "training_checkpoints", "ckpt-100000.msgpack"))
        shutil.copy(os.path.join(r4, "config.json"), tmp)  # the run cli infer reads
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        np.save(os.path.join(data, "x_train_sinograms.npy"), np.asarray(sinos_all[:SETUP_SCANS]))
        shutil.copy(os.path.join(ROOT, "dataset_foam", "dataset_parameters.npy"), data)
        setup = _setup_s(tmp, data, os.path.join(tmp, "out"), dev)
        tcfg = cfg.replace(save_path=tmp, truncate_dataset=len(sinos), restore=True,
                           use_latest_ckpt=True, cheap_init=True)
        tr = Trainer(tcfg, sinos, theta, dev)
        rng = np.random.default_rng(0)
        bidx = torch.as_tensor(rng.permutation(len(sinos))[: cfg.batch_size], device=dev)
        aidx = torch.as_tensor(rng.permutation(len(theta))[: cfg.angles_per_iter], device=dev)
        shapes, out_shape = tr.draw_shapes(cfg.batch_size)
        sb = cfg.num_samples * cfg.batch_size
        recon = torch.rand((sb, tr.x_size, tr.y_size), device=dev, requires_grad=True)
        weight = torch.rand((sb, cfg.angles_per_iter, tr.n_det), device=dev)
        route_fn = lambda: tr.project(recon, aidx).backward(weight)
        route = route_in_turns(route_fn, route_fn, joseph_radon, _cuda)
        b_host, a_host = bidx.cpu().numpy(), aidx.cpu().numpy()
        # name: (call, steps a call)
        if hasattr(tr, "train_chunk"):
            # the steps as the loops run them: the eval step drawing from a
            # generator (amortized_infer's TorchSampler), the train step from
            # its own, with host indices
            from ct_pvae_tpu_torch.vi.infer import TorchSampler

            draws = TorchSampler(0, dev)(0, 0, shapes, out_shape, cfg.num_samples)
            k = cfg.steps_per_call
            steps = {
                "eval_step": (lambda: tr.eval_step(bidx, draws), 1),
                "train_step": (lambda: tr.train_step(b_host, a_host), 1),
                "train_graphed": (lambda: tr.train_chunk([b_host] * k, [a_host] * k), k),
            }
        else:  # a tree before the graphed step: Draws made before each step
            draws = tr.sampler("eval", 0, shapes, out_shape, cfg.num_samples)
            steps = {
                "eval_step": (lambda: tr.eval_step(bidx, draws), 1),
                "train_step": (lambda: tr.train_step(bidx, aidx, tr.sampler(
                    "train", tr.step, shapes, out_shape, cfg.num_samples)), 1),
            }
        results = {}
        for name, (step, k) in steps.items():
            wall, busy = _wall_and_busy(step, max(1, args.steps // k))
            dev_ms, host_us, covered = cuda_time(step, 5)
            results[name] = {"wall_ms": wall / k, "busy_ms": busy / k, "device_ms": dev_ms / k,
                             "host_ms": host_us / 1e3 / k, "covered": covered}
        # a captured graph keeps the kernels it captured: the first designs
        # swap into the eager steps only
        swappable = [name for name in steps if name != "train_graphed"]
        turns = {"own": {name: [] for name in steps}, "first_designs": {name: [] for name in swappable}}
        for _ in range(3):
            for projector, walls in turns.items():
                restore = (_swap_in_first_designs(joseph_radon, _cuda) if projector == "first_designs"
                           else lambda: None)
                for name in walls:
                    step, k = steps[name]
                    walls[name].append(_wall(step, max(1, args.steps // k)) / k)
                restore()
    print(json.dumps({
        "tree": os.path.abspath(args.tree), "package": os.path.dirname(ct_pvae_tpu_torch.__file__),
        "device": torch.cuda.get_device_name(0), "launches": dict(joseph_radon.LAUNCHES),
        "route_fwd_bwd_in_turns": route, **results, "wall_ms_in_turns": turns,
        "serve_real_setup_s": setup}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
