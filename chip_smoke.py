#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ct_pvae_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero:

  1. device  - the card (nvidia-smi name and power limit), torch, CUDA, TF32
  2. build   - nvcc builds every kernel from csrc/, one process per source,
               all started together; ptxas's registers and spills for each kernel
  3. kernels - the launch floor (a one-element torch op); each kernel against
               its plain PyTorch version at the shapes the main paths give
               it: A (radon_fused on the forward kernel) at the serving and
               the training shape, B (its backward, on the adjoint kernel) at
               the training shape, both on the kernel rows of the call's
               angles as Server.project selects them, and at odd calls
               (indices all past 20, one major axis, duplicates, batches 1
               and 3, an odd size); C and D (the static pair) at the
               init-stack shape and at ragged batches 8, 4 and 1; A, B, C
               and D at 1200 angles; every kernel timed with the host held
               out (a spin kernel covers the enqueue, so the events bracket
               device time only), with its host us per call, beside its old
               design (A's and B's first designs, csrc/joseph_{fwd,adj}.cu),
               its plain version and its library call; the route's host
               and device cost in turns with the first designs
               (scripts/step_cost.py route_in_turns); the kernel's bound;
               <Ax, g> = <x, A^T g>; SIRT and TV on 32 sinograms through
               the new pair and the old design
  4. serve   - ``ct_pvae_tpu_torch.cli infer --cheap_init`` on the first 100
               sinograms of dataset_foam with the foam paper run's weights
               (results/foam_paper_run_r4), at full width; launch counts,
               finite outputs, PSNR against the ground truth, and one eval
               step held against the port's CPU path on the same draws
  5. train   - ``ct_pvae_tpu_torch.cli train`` restores the r4 checkpoint
               (params and Adam state) and trains 100 more steps at full
               width on the first 100 sinograms, with the paper's init stack
               (sirt/tv through C and D); launch counts, finite losses,
               posterior-mean PSNR of the final evaluation, one train step
               (loss and every gradient) held against the port's CPU path,
               and a torch.profiler view of the step
  6. gather  - ``cli train --config configs/toy.yaml`` on dataset_toy_discrete2
               (64 sinograms, a 2-pixel detector), cut to 200 steps: the
               gather projector's calls move and no Joseph kernel launches,
               finite losses, one toy train step held against the CPU path
               and a torch.profiler view of it
  7. serve on the real init stack - ``cli infer`` without ``--cheap_init``
               (sirt/tv through C and D) on phase 4's 100 sinograms with the
               r4 weights; launch counts, set-up seconds, PSNR
  8. kernel E - the probe ``python -m ct_pvae_tpu_torch.scripts.probe_conv_fused``
               at its default shape (its lines and verdict; its launches of E
               are E's count), then E against its plain version at the
               probe's shape and a ragged one, E, plain and cuDNN times, bound

The last two lines are the nvidia-smi line and
{"ok": true, "device": {...}}; a line before them holds the per-kernel JSON.
Without a CUDA device the script prints no result and exits 1.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense, no sparsity), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

N_SERVE = 100
PASSES = 8
N_TRAIN = 100            # examples the train phase restores onto
TRAIN_STEPS = 100
TOY_STEPS = 200          # the toy recipe's 100,000 steps, cut
INIT_BATCH = 32          # classical_recon_stack's batch
PSNR_FLOOR_DB = 15.0
KERNEL_RTOL = 1e-5       # relative, plus KERNEL_ATOL_FRAC * max|plain|:
KERNEL_ATOL_FRAC = 1e-5  # the kernel and plain version differ in summation order only
ADJOINT_RTOL = 1e-6      # <Ax, g> against <x, A^T g>, float64 sums of float32 terms: the
                         # forward and adjoint kernels' taps are bitwise the same
MANY_ANGLES = 1200       # above the 1024 that B and D once took
CPU_EVAL_RTOL = 1e-3     # GPU (cuDNN, no TF32) vs CPU eval step on the same draws
CPU_STEP_LOSS_RTOL = 1e-5  # GPU vs CPU train step: the loss
CPU_GRAD_RTOL = 2e-2       # and each gradient's error norm over its norm: cuDNN runs
                           # some backward convs as float32 FFTs (fft2d_r2c + complex
                           # gemm in the profile), 4.6e-3 at most on an H100


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, repeats: int, per_sample: int = 1):
    """(device ms, host us, covered) per call of ``fn()``, with the host held
    out of the device time: ``ct_pvae_tpu_torch/scripts/step_cost.py``'s
    ``cuda_time`` (a spin kernel covers each sample's enqueue)."""
    from ct_pvae_tpu_torch.scripts.step_cost import cuda_time as timer

    return timer(fn, repeats, per_sample)


def cuda_ms(fn, repeats: int, per_sample: int = 1) -> float:
    """The device ms per call of ``cuda_time``."""
    return cuda_time(fn, repeats, per_sample)[0]


def joseph_taps(table, n: int, n_det: int):
    """(row, column, value) of the projector as a sparse (A*n_det, n*n) matrix:
    the in-range hat taps of every ray, the weight folded in."""
    import torch

    dev = table.device
    a = table.shape[0]
    t = torch.arange(n_det, dtype=torch.float32, device=dev)[None, :, None]
    r = torch.arange(n, dtype=torch.float32, device=dev)[None, None, :]
    col = lambda i: table[:, i][:, None, None]
    pos = (col(2) + col(0) * t) + col(1) * r                    # (A, T, N)
    y0 = torch.floor(pos)
    is_y = col(4) > 0.5
    ray = (torch.arange(a, device=dev)[:, None, None] * n_det
           + torch.arange(n_det, device=dev)[None, :, None]).expand_as(pos)
    rows, cols, vals = [], [], []
    for yk in (y0, y0 + 1.0):
        keep = (yk >= 0) & (yk <= n - 1)
        hat = torch.clamp(1.0 - torch.abs(yk - pos), min=0.0) * col(3)
        yi, ri = yk.long(), r.long().expand_as(pos)
        pix = torch.where(is_y, yi * n + ri, ri * n + yi)
        rows.append(ray[keep])
        cols.append(pix[keep])
        vals.append(hat[keep])
    return torch.cat(rows), torch.cat(cols), torch.cat(vals)


def csr(rows, cols, vals, shape):
    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "sparse CSR support is in beta"
        return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape).coalesce().to_sparse_csr()


def compare(label, what: str, got, want) -> float:
    """Raise unless ``got`` holds ``want`` to rtol KERNEL_RTOL + KERNEL_ATOL_FRAC
    * max|want| and is finite; log and return the largest absolute error."""
    import torch

    err = (got - want).abs()
    scale = float(want.abs().max())
    max_abs = float(err.max())
    bad = int((err > KERNEL_RTOL * want.abs() + KERNEL_ATOL_FRAC * scale).sum())
    log(f"  {label}: {what} -> {tuple(got.shape)}; "
        f"max abs err {max_abs:.3e}, max rel err {max_abs / scale:.3e} (of max {scale:.4g}); "
        f"{bad} outside rtol {KERNEL_RTOL:g} + atol {KERNEL_ATOL_FRAC:g}*max")
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: kernel disagrees with its plain version")
    return max_abs


def bound(bytes_moved: int, ops: int):
    """(bound ms, "bytes" or "operations", its log text): the larger of the
    bytes over the memory rate and the float32 operations over their peak."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    text = (f"bound {max(bytes_ms, ops_ms):.5f} ms by {by} (bytes {bytes_moved} B -> "
            f"{bytes_ms:.5f} ms at 3.35 TB/s; {ops} flops -> {ops_ms:.5f} ms at 67 TFLOP/s)")
    return max(bytes_ms, ops_ms), by, text


def check_kernel(label, kernel, plain, x, table, n, n_det, adjoint=False, old=None):
    """Kernel vs plain version on ``x``, times (host held out), bound, and the
    same function as one cuSPARSE product (the projector's CSR matrix, or its
    transpose for an adjoint); with ``old``, the old design of the same
    function timed in turns with the kernel (kernel, old, three times; each
    time the median of its three medians).  ``table``: the call's (A, 5) table
    or (A, 8) kernel rows.  Returns the kernel's record."""
    import torch

    b = x.shape[0]
    a = table.shape[0]
    got = kernel(x)
    want = plain(x)
    torch.cuda.synchronize()
    max_abs = compare(label, f"{tuple(x.shape)} x {a} angles", got, want)

    fns = (kernel,) if old is None else (kernel, old) * 3
    turns = [cuda_time(lambda: fn(x), 10, per_sample=20) for fn in fns]
    mid = lambda v: sorted(v)[len(v) // 2]
    ms, host_us = mid([t[0] for t in turns[::2]]), mid([t[1] for t in turns[::2]])
    covered = all(t[2] for t in turns[::2])  # False: host time in a sample's window
    plain_ms, _, plain_covered = cuda_time(lambda: plain(x), 3)

    rows, cols, vals = joseph_taps(table, n, n_det)
    if adjoint:
        mat = csr(cols, rows, vals, (n * n, a * n_det))
    else:
        mat = csr(rows, cols, vals, (a * n_det, n * n))
    flat = x.reshape(b, -1).t().contiguous()
    lib_err = float(((mat @ flat).t().reshape(got.shape) - want).abs().max())
    library_ms = cuda_ms(lambda: mat @ flat, 10, per_sample=5)

    taps = int(rows.numel()) * b
    sino_numel = b * a * n_det
    bytes_moved = (x.numel() + a * 5 + got.numel()) * 4
    ops = 2 * taps + sino_numel  # a multiply-add per in-range tap, one weight scale per ray
    bound_ms, bound_by, text = bound(bytes_moved, ops)
    log(f"  {label}: kernel {ms:.4f} ms device{'' if covered else ' (host in the window)'}, "
        f"{host_us:.1f} us host per call (medians of 10 x 20 queued launches behind a spin), "
        f"plain {plain_ms:.3f} ms{'' if plain_covered else ' (host in the window)'}, cuSPARSE "
        f"csr@dense {library_ms:.4f} ms (max abs err {lib_err:.2e}); {text}; {taps} taps")
    record = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                  bound_by=bound_by, library_ms=library_ms, host_us=host_us, covered=covered)
    if old is not None:
        old_ms, old_us = mid([t[0] for t in turns[1::2]]), mid([t[1] for t in turns[1::2]])
        old_covered = all(t[2] for t in turns[1::2])
        old_err = float((old(x) - want).abs().max())
        log(f"  {label}: old design {old_ms:.4f} ms device{'' if old_covered else ' (host in the window)'}, "
            f"{old_us:.1f} us host (max abs err {old_err:.2e}); in turns, kernel "
            f"{' / '.join(f'{t[0]:.4f}' for t in turns[::2])} ms, "
            f"old {' / '.join(f'{t[0]:.4f}' for t in turns[1::2])} ms: "
            f"{old_ms / ms:.2f}x faster, {library_ms / ms:.2f}x faster than cuSPARSE")
        record.update(old_design_ms=old_ms, old_design_covered=old_covered)
    return record


def check_conv_fused(label, x, kern, bias, timed: bool):
    """Kernel E against its plain version on ``x``; with ``timed``, also the
    kernel's, the plain version's and the cuDNN formulation's times and E's
    bound; returns the kernel's record."""
    import torch

    from ct_pvae_tpu_torch.ops import conv_fused
    from ct_pvae_tpu_torch.scripts.probe_conv_fused import f_cudnn

    kernel = lambda: conv_fused.conv3x3_periodic_maxout(x, kern, bias)
    plain = lambda: conv_fused.conv3x3_periodic_maxout_plain(x, kern, bias)
    library = lambda: f_cudnn(x, kern, bias)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    max_abs = compare(label, f"{tuple(x.shape)} x {tuple(kern.shape)}", got, want)
    if not timed:
        return None
    lib_err = float((library() - want).abs().max())
    ms, host_us, _ = cuda_time(kernel, 10, per_sample=20)
    plain_ms = cuda_ms(plain, 3)
    library_ms = cuda_ms(library, 10, per_sample=5)
    b, h, w, c = x.shape
    f = kern.shape[-1] // 2
    bytes_moved = (x.numel() + kern.numel() + bias.numel() + got.numel()) * 4
    ops = 2 * b * h * w * 9 * c * 2 * f  # a multiply-add per tap, channel and output channel
    bound_ms, bound_by, text = bound(bytes_moved, ops)
    log(f"  {label}: kernel {ms:.4f} ms device, {host_us:.1f} us host per call (medians of 10 x 20 "
        f"queued launches behind a spin, {ops / ms / 1e9:.2f} TFLOP/s), plain (im2col + matmul) "
        f"{plain_ms:.4f} ms, cuDNN formulation {library_ms:.4f} ms (max abs err {lib_err:.2e}); {text}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, host_us=host_us)


def check_adjoint(label, fwd, adj, x, g, rtol=ADJOINT_RTOL) -> None:
    """<fwd(x), g> against <x, adj(g)> on the card."""
    lhs = float((fwd(x).double() * g.double()).sum())
    rhs = float((x.double() * adj(g).double()).sum())
    rel = abs(lhs - rhs) / abs(lhs)
    log(f"  {label}: <Ax, g> {lhs:.10g} vs <x, A^T g> {rhs:.10g} (rel {rel:.2e}, tolerance {rtol:g})")
    if not rel <= rtol:
        raise AssertionError(f"{label}: the adjoint kernel is not the forward's transpose")


def check_eval_step(cfg, sinos, theta, run_path, dev) -> None:
    """One eval step of the served model on the card against the port's CPU
    path (plain projector, CPU convs), on the same data and draws; returns
    the card's server and draws."""
    import numpy as np
    import torch

    from ct_pvae_tpu_torch.vi.infer import TorchSampler
    from ct_pvae_tpu_torch.vi.loss import Draws
    from ct_pvae_tpu_torch.vi.serve import Server

    eval_cfg = cfg.replace(save_path=None, truncate_dataset=len(sinos), cheap_init=True,
                           real_data=True)
    results, draws, srv_gpu = [], None, None
    for d in (dev, torch.device("cpu")):
        # the CPU server asks for the card's projector route (Joseph, plain versions)
        srv = Server(eval_cfg, sinos, theta, d, kernel_route=True)
        srv.restore(run_path)
        if srv_gpu is None:
            srv_gpu = srv
        if draws is None:
            shapes, out_shape = srv.draw_shapes(len(sinos))
            draws = TorchSampler(1, dev)(0, 0, shapes, out_shape, cfg.num_samples)
        d_draws = Draws([[e.to(d) for e in es] for es in draws.eps], [u.to(d) for u in draws.u])
        loss, aux = srv.eval_step(torch.arange(len(sinos), device=d), d_draws)
        results.append((float(loss), aux.recon_mean.cpu().numpy()))
    (l_gpu, m_gpu), (l_cpu, m_cpu) = results
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    m_err = float(np.abs(m_gpu - m_cpu).max())
    log(f"[serve] eval step GPU vs CPU: loss {l_gpu:.7g} vs {l_cpu:.7g} (rel {rel:.2e}), "
        f"recon_mean max abs diff {m_err:.2e}; tolerance {CPU_EVAL_RTOL:g}")
    if not (rel <= CPU_EVAL_RTOL and m_err <= CPU_EVAL_RTOL):
        raise AssertionError("GPU eval step disagrees with the CPU path")
    return srv_gpu, draws


def profile_eval_step(srv, draws, steps: int = 5) -> None:
    """Where one eval step's time goes on the card: torch.profiler's device
    time by kernel over ``steps`` steps, against their synchronised wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    idx = torch.arange(draws.u[0].shape[0], device=draws.u[0].device)
    srv.eval_step(idx, draws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            srv.eval_step(idx, draws)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side entries only (kernels, copies): the CPU ops that launched
    # them report the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events)
    log(f"[profile] eval step (batch {idx.numel()}, all angles): wall {wall_us / steps / 1e3:.3f} ms, "
        f"device busy {device_us / steps / 1e3:.3f} ms ({100 * device_us / wall_us:.1f}% of wall)")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        log(f"[profile]   {e.self_device_time_total / steps / 1e3:8.4f} ms "
            f"{100 * e.self_device_time_total / max(device_us, 1e-9):5.1f}%  x{e.count // steps}  {e.key[:90]}")


def check_train_step(cfg, sinos, theta, run_path, dev, label="train"):
    """One train step of a run's restored model on the card against the
    port's CPU path, on the same params, batch, angles and draws: loss and
    every gradient.  The CPU trainer reads the card's masks, measurements and
    init stack from their cache files, and takes the card's projector route.
    Returns the card's trainer."""
    import numpy as np
    import torch

    from ct_pvae_tpu_torch.vi.train import Trainer

    tcfg = cfg.replace(save_path=run_path, truncate_dataset=len(sinos), restore=True,
                       use_latest_ckpt=True, reuse_cache=True)
    gpu = Trainer(tcfg, sinos, theta, dev)
    cpu = Trainer(tcfg, sinos, theta, torch.device("cpu"), kernel_route=True)
    if gpu.joseph != cpu.joseph:
        raise AssertionError("the CPU trainer took another projector route than the card's")
    rng = np.random.default_rng(0)
    bidx = rng.permutation(len(sinos))[: cfg.batch_size]
    aidx = rng.permutation(len(theta))[: cfg.angles_per_iter]
    shapes, out_shape = gpu.draw_shapes(cfg.batch_size)
    draws = gpu.sampler("train", gpu.step, shapes, out_shape, cfg.num_samples)
    out = []
    for tr in (gpu, cpu):
        d = tr.device
        dd = type(draws)([[e.to(d) for e in es] for es in draws.eps], [u.to(d) for u in draws.u])
        loss, _, grads = tr.loss_and_grads(torch.as_tensor(bidx, device=d),
                                           torch.as_tensor(aidx, device=d), dd)
        out.append((loss.item(), [g.cpu() for g in grads]))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    names = [f"{m}.{k}" for m, model in gpu.models.items() for k, _ in model.named_parameters()]
    errs = sorted(((float((a - b).norm() / b.norm().clamp_min(1e-30)), k)
                   for k, a, b in zip(names, g_gpu, g_cpu)), reverse=True)
    whole = float(torch.cat([(a - b).flatten() for a, b in zip(g_gpu, g_cpu)]).norm()
                  / torch.cat([b.flatten() for b in g_cpu]).norm())
    log(f"[{label}] one step GPU vs CPU: loss {l_gpu:.7g} vs {l_cpu:.7g} (rel {rel:.2e}, tolerance "
        f"{CPU_STEP_LOSS_RTOL:g}); gradient error norm / norm: all {len(g_gpu)} tensors together "
        f"{whole:.2e}, largest {', '.join(f'{k} {e:.2e}' for e, k in errs[:3])} "
        f"(tolerance {CPU_GRAD_RTOL:g} each)")
    if not (rel <= CPU_STEP_LOSS_RTOL and errs[0][0] <= CPU_GRAD_RTOL):
        raise AssertionError(f"{label}: GPU train step disagrees with the CPU path")
    return gpu, bidx, aidx


def profile_train_step(tr, bidx, aidx, steps: int = 5, label: str = "train step") -> dict:
    """torch.profiler's device time by kernel over ``steps`` train steps,
    against their synchronised wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = tr.cfg
    shapes, out_shape = tr.draw_shapes(cfg.batch_size)
    b = torch.as_tensor(bidx, device=tr.device)
    a = torch.as_tensor(aidx, device=tr.device)

    def step():
        return tr.train_step(b, a, tr.sampler("train", tr.step, shapes, out_shape, cfg.num_samples))

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events)
    log(f"[profile] {label} (batch {cfg.batch_size}, {cfg.angles_per_iter} angles, "
        f"{cfg.num_samples} ELBO samples): "
        f"{plain_wall * 1e3:.3f} ms unprofiled; profiled wall {wall_us / steps / 1e3:.3f} ms, "
        f"device busy {device_us / steps / 1e3:.3f} ms ({100 * device_us / wall_us:.1f}% of wall)")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        log(f"[profile]   {e.self_device_time_total / steps / 1e3:8.4f} ms "
            f"{100 * e.self_device_time_total / max(device_us, 1e-9):5.1f}%  x{e.count // steps}  {e.key[:90]}")
    return dict(step_ms=plain_wall * 1e3, busy=device_us / wall_us)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from ct_pvae_tpu_torch import cli
    from ct_pvae_tpu_torch.config import Config
    from ct_pvae_tpu_torch.data.io import load_dataset
    from ct_pvae_tpu_torch.device import exact_f32
    from ct_pvae_tpu_torch.eval.metrics import mean_psnr
    from ct_pvae_tpu_torch.ops import _cuda, conv_fused, joseph_radon, radon, sirt, tv
    from ct_pvae_tpu_torch.scripts import probe_conv_fused
    from ct_pvae_tpu_torch.scripts.step_cost import route_in_turns

    t_all = time.perf_counter()
    # -- 1. device -------------------------------------------------------
    smi = nvidia_smi_line()
    exact_f32()
    dev = torch.device("cuda")
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    sources = ("joseph_fwd", "joseph_adj", "joseph_fwd_static", "joseph_adj_static", "conv_fused")
    _cuda.load_libraries(*sources)
    log(f"[build] {', '.join(f'{n}.cu' for n in sources)} built in parallel and loaded in "
        f"{time.perf_counter() - t0:.2f} s into {_cuda.BUILD_DIR}")
    for name in sources:  # ptxas -v: spills and registers of each kernel instantiation
        for line in _cuda.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {name}.cu: {line.split(':', 1)[-1].strip()}")

    # -- 3. kernels against their plain versions --------------------------
    jr = joseph_radon
    sinos_all, theta, n_det = load_dataset(os.path.join(REPO, "dataset_foam"))
    cfg = Config.load(os.path.join(REPO, "results", "foam_paper_run_r4", "config.json"))
    n = int(np.floor(n_det / np.sqrt(2) - 2))  # recon size rule: 128 at 184 detectors
    sb = cfg.num_samples * cfg.batch_size      # merged S*B projector batch
    gen = torch.Generator(device=dev).manual_seed(0)
    one = torch.zeros(1, device=dev)
    floor_ms, floor_us, _ = cuda_time(lambda: one.add_(1.0), 10, per_sample=20)
    log(f"  launch floor (a one-element add_, timed as the kernels): {floor_ms:.4f} ms device, "
        f"{floor_us:.1f} us host per call")
    image = torch.rand((sb, n, n), generator=gen, device=dev)
    # A and B read the kernel rows of the call's angles, selected on the card
    # from the full table's rows as Server.project selects them; the first
    # designs and the plain versions read the same angles' (A, 5) table
    table = torch.as_tensor(jr.angle_table_fused(np.asarray(theta, np.float32), n, n, n_det), device=dev)
    rows = torch.as_tensor(jr.kernel_rows(table.cpu().numpy()), device=dev)
    a_old = lambda tab: (lambda x: _cuda.joseph_fwd(x, tab, n_det))
    b_old = lambda tab: (lambda g: _cuda.joseph_adj(g, tab, n))
    records = {}
    records["joseph_fwd"] = check_kernel(
        "A serving", lambda x: jr.radon_fused(x, rows, n_det),
        lambda x: jr.radon_fused_plain(x, table, n_det), image, table, n, n_det, old=a_old(table))
    aidx = torch.randperm(len(theta), generator=gen, device=dev)[: cfg.angles_per_iter]
    rows_sub, sub = rows.index_select(0, aidx), table.index_select(0, aidx)
    records["joseph_fwd"]["at_20_angles"] = check_kernel(
        "A training", lambda x: jr.radon_fused(x, rows_sub, n_det),
        lambda x: jr.radon_fused_plain(x, sub, n_det), image, sub, n, n_det, old=a_old(sub))
    g_sub = torch.randn((sb, cfg.angles_per_iter, n_det), generator=gen, device=dev)
    records["joseph_adj"] = check_kernel(
        "B training", lambda g: jr.radon_fused_adjoint(g, rows_sub, n),
        lambda g: jr.radon_fused_adjoint_plain(g, sub, n), g_sub, sub, n, n_det, adjoint=True,
        old=b_old(sub))
    check_adjoint("A/B training", lambda x: jr.radon_fused(x, rows_sub, n_det),
                  lambda g: jr.radon_fused_adjoint(g, rows_sub, n), image, g_sub)
    # the route as the train step calls it (select the step's rows, forward
    # through the autograd Function, backward), in turns with the same route
    # on the first designs and the (A, 5) table: device ms and host us a call
    x_leaf = image.clone().requires_grad_()
    turns = route_in_turns(
        lambda: jr.radon_fused(x_leaf, rows.index_select(0, aidx), n_det).backward(g_sub),
        lambda: jr.radon_fused(x_leaf, table.index_select(0, aidx), n_det).backward(g_sub),
        jr, _cuda)
    log("  A + B route at the training shape (index_select, forward, backward) in turns with the "
        "first designs: " + ", ".join(
            f"{'new' if t['projector'] == 'own' else 'old'} {t['device_ms']:.4f} ms device"
            f"{'' if t['covered'] else ' (host in the window)'}, {t['host_us']:.1f} us host"
            for t in turns))
    # odd calls of A and B: output angles far below the full table's, one
    # major axis only, duplicates, batches 1 and 3, an odd size
    th32 = np.asarray(theta, np.float32)
    x_major = np.flatnonzero(np.abs(np.cos(th32)) >= np.abs(np.sin(th32)))
    rng = np.random.default_rng(0)
    odd_calls = {
        "past 20": (n, n_det, rng.choice(np.arange(20, len(theta)), 20, replace=False), sb),
        "one axis": (n, n_det, rng.choice(x_major, 20, replace=False), sb),
        "duplicates": (n, n_det, np.array([5, 5, 170, 90, 5, 170, 33]), sb),
        "batch 1": (n, n_det, rng.permutation(len(theta))[:20], 1),
        "batch 3": (n, n_det, rng.permutation(len(theta))[:20], 3),
        "odd size": (33, 50, rng.permutation(len(theta))[:20], 5),
    }
    for name, (on, ot, idx, ob) in odd_calls.items():
        otab = torch.as_tensor(jr.angle_table_fused(th32, on, on, ot), device=dev)
        orows = torch.as_tensor(jr.kernel_rows(otab.cpu().numpy()), device=dev)
        sel = torch.as_tensor(idx, device=dev)
        orows, otab = orows.index_select(0, sel), otab.index_select(0, sel)
        xo = torch.rand((ob, on, on), generator=gen, device=dev)
        go = torch.randn((ob, len(idx), ot), generator=gen, device=dev)
        what = f"{tuple(xo.shape)} x {len(idx)} angles -> {ot} bins"
        a_fn = lambda x: jr.radon_fused(x, orows, ot)
        b_fn = lambda g: jr.radon_fused_adjoint(g, orows, on)
        compare(f"A {name}", what, a_fn(xo), jr.radon_fused_plain(xo, otab, ot))
        compare(f"B {name}", what, b_fn(go), jr.radon_fused_adjoint_plain(go, otab, on))
        check_adjoint(f"A/B {name}", a_fn, b_fn, xo, go.abs())  # g >= 0: no cancellation
    theta_f = tuple(float(t) for t in theta)   # the init stack: detector-size images
    full = jr.static_table(theta_f, n_det, n_det, dev)
    img_init = torch.rand((INIT_BATCH, n_det, n_det), generator=gen, device=dev)
    sino_init = torch.rand((INIT_BATCH, len(theta), n_det), generator=gen, device=dev)
    c_new = lambda x: jr.radon_static(x, theta_f, n_det)
    d_new = lambda g: jr.backproject_static(g, theta_f, n_det, n_det)
    c_plain = lambda x: jr.radon_fused_plain(x, full, n_det)
    d_plain = lambda g: jr.radon_fused_adjoint_plain(g, full, n_det)
    c_old = lambda x: _cuda.joseph_fwd(x, full, n_det)  # the old design of C and D: the
    d_old = lambda g: _cuda.joseph_adj(g, full, n_det)  # first designs of A and B on the full table
    records["joseph_fwd_static"] = check_kernel(
        "C init", c_new, c_plain, img_init, full, n_det, n_det, old=c_old)
    records["joseph_adj_static"] = check_kernel(
        "D init", d_new, d_plain, sino_init, full, n_det, n_det, adjoint=True, old=d_old)
    check_adjoint("C/D init", c_new, d_new, img_init, sino_init)
    for rb in (8, 4, 1):  # ragged last init batches (1000 scans end on 8, 100 on 4)
        xr, gr = img_init[:rb].contiguous(), sino_init[:rb].contiguous()
        compare(f"C ragged {rb}", f"{tuple(xr.shape)} x {len(theta)} angles", c_new(xr), c_plain(xr))
        compare(f"D ragged {rb}", f"{tuple(gr.shape)}", d_new(gr), d_plain(gr))
        check_adjoint(f"C/D ragged {rb}", c_new, d_new, xr, gr)
    # C and D loading element by element: n and n_det not multiples of 4, or
    # image and sinogram not on 16 bytes (a view one float into its storage)
    for rb, rn, ra, rt, off in ((5, 37, 53, 50, 0), (6, 32, 20, 48, 1)):
        th = tuple(float(t) for t in np.linspace(0, np.pi, ra, endpoint=False))
        tab = jr.static_table(th, rn, rt, dev)
        xo = torch.zeros(rb * rn * rn + off, device=dev)[off:].view(rb, rn, rn)
        go = torch.zeros(rb * ra * rt + off, device=dev)[off:].view(rb, ra, rt)
        xo.copy_(torch.rand((rb, rn, rn), generator=gen, device=dev))
        go.copy_(torch.randn((rb, ra, rt), generator=gen, device=dev))
        what = f"{tuple(xo.shape)} x {ra} angles -> {rt} bins, {off} float(s) into the storage"
        c_odd = lambda x: jr.radon_static(x, th, rt)
        d_odd = lambda g: jr.backproject_static(g, th, rn, rn)
        compare("C odd", what, c_odd(xo), jr.radon_fused_plain(xo, tab, rt))
        compare("D odd", what, d_odd(go), jr.radon_fused_adjoint_plain(go, tab, rn))
        check_adjoint(f"C/D odd {tuple(xo.shape)}", c_odd, d_odd, xo, go)
    # the last init batch of 100 scans, in turns with the old design
    x4, g4 = img_init[:4].contiguous(), sino_init[:4].contiguous()
    c_bare = lambda x: jr._static_forward(x, theta_f, n_det)  # C without its autograd Function
    t_c, t_c_bare, t_c_old, t_d, t_d_old = (
        cuda_ms(lambda: fn(v), 10, per_sample=20)
        for fn, v in ((c_new, x4), (c_bare, x4), (c_old, x4), (d_new, g4), (d_old, g4)))
    log(f"  C/D ragged 4: C {t_c:.4f} ms (without the autograd Function {t_c_bare:.4f}; old design "
        f"{t_c_old:.4f}), D {t_d:.4f} ms (old design {t_d_old:.4f}), medians of 10 x 20 queued "
        f"launches behind a spin")
    # SIRT (30 iterations) and TV (60) on 32 sinograms through the new pair
    # and the old design: the same taps, another summation order
    sino32 = torch.as_tensor(np.clip(np.asarray(sinos_all[:INIT_BATCH], np.float32), 0, None), device=dev)
    for alg, fn, iters in (("sirt", sirt.sirt_with_ops, 30), ("tv", tv.tv_with_ops, 60)):
        new = fn(sino32, c_new, d_new, n_det, n_det, num_iter=iters)
        ref = fn(sino32, c_old, d_old, n_det, n_det, num_iter=iters)
        rel = float((new - ref).abs().max() / ref.abs().max())
        log(f"  {alg} ({iters} iterations) on {tuple(sino32.shape)}: new pair vs old design, max abs "
            f"diff / max {rel:.2e}, norm of diff / norm {float((new - ref).norm() / ref.norm()):.2e}")
        if alg == "sirt" and not rel <= 1e-3:  # rounding, through 30 iterations
            raise AssertionError("SIRT on the new pair is not the old design's to rounding")
    # above 1024 angles: the adjoint stages its rows in chunks, the forward
    # finds its groups over chunks of its threads
    theta_many = tuple(float(t) for t in np.linspace(0, np.pi, MANY_ANGLES, endpoint=False))
    many = jr.static_table(theta_many, 32, 48, dev)
    many_rows = jr.static_rows(theta_many, 32, 48, dev)
    g_many = torch.randn((3, MANY_ANGLES, 48), generator=gen, device=dev)
    x_many = torch.rand((3, 32, 32), generator=gen, device=dev)
    adj_many = jr.radon_fused_adjoint_plain(g_many, many, 32)
    fwd_many = jr.radon_fused_plain(x_many, many, 48)
    compare(f"B {MANY_ANGLES} angles", f"{tuple(g_many.shape)}", jr.radon_fused_adjoint(g_many, many_rows, 32),
            adj_many)
    compare(f"D {MANY_ANGLES} angles", f"{tuple(g_many.shape)}",
            jr.backproject_static(g_many, theta_many, 32, 32), adj_many)
    compare(f"A {MANY_ANGLES} angles", f"{tuple(x_many.shape)}", jr.radon_fused(x_many, many_rows, 48), fwd_many)
    compare(f"C {MANY_ANGLES} angles", f"{tuple(x_many.shape)}", jr.radon_static(x_many, theta_many, 48),
            fwd_many)
    log("[kernels] ok")

    # -- 4. serve --------------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        run = os.path.join(tmp, "run")
        os.makedirs(os.path.join(run, "training_checkpoints"))
        r4 = os.path.join(REPO, "results", "foam_paper_run_r4")
        shutil.copy(os.path.join(r4, "config.json"), run)
        os.symlink(os.path.join(r4, "ckpt-100000.msgpack"),
                   os.path.join(run, "training_checkpoints", "ckpt-100000.msgpack"))
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        np.save(os.path.join(data, "x_train_sinograms.npy"), np.asarray(sinos_all[:N_SERVE]))
        shutil.copy(os.path.join(REPO, "dataset_foam", "dataset_parameters.npy"), data)
        out_dir = os.path.join(tmp, "out")

        for k in joseph_radon.LAUNCHES:
            joseph_radon.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        rc = cli.main(["infer", "--run_path", run, "--input_path", data, "--output", out_dir,
                       "--cheap_init", "--passes", str(PASSES)])
        wall = time.perf_counter() - t0
        launches = dict(joseph_radon.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"cli infer returned {rc}")
        # serving runs kernel A only: no backward, and cheap init runs no sirt/tv
        expected = {"joseph_fwd": -(-N_SERVE // cfg.batch_size) * PASSES, "joseph_adj": 0,
                    "joseph_fwd_static": 0, "joseph_adj_static": 0}
        log(f"[serve] launches {launches} (expected {expected}: A once per pass per batch)")
        if launches != expected:
            raise AssertionError(f"serving launches {launches}, expected {expected}")

        mean = np.load(os.path.join(out_dir, "reconstruction_mean.npy"))
        std = np.load(os.path.join(out_dir, "reconstruction_std.npy"))
        sample = np.load(os.path.join(out_dir, "reconstruction_sample.npy"))
        loss = np.load(os.path.join(out_dir, "infer_loss.npy"))
        with open(os.path.join(out_dir, "infer_timing.json")) as f:
            timing = json.load(f)
        for name, arr in (("mean", mean), ("std", std), ("sample", sample)):
            if arr.shape != (N_SERVE, n, n, 1) or not np.isfinite(arr).all():
                raise AssertionError(f"{name}: shape {arr.shape} or non-finite values")
        if (std < 0).any() or not np.isfinite(loss).all():
            raise AssertionError("negative std or non-finite loss")
        truth = np.load(os.path.join(REPO, "foam_training.npy"), mmap_mode="r")[:N_SERVE]
        psnr_mean = mean_psnr(truth, mean[..., 0])
        psnr_sample = mean_psnr(truth, sample[..., 0])
        # steady state: every batch after the first (which pays cuDNN's warm-up)
        steady = timing["batch_s"][1:]
        ex_s = len(steady) * timing["batch_size"] / sum(steady)
        log(f"[serve] {N_SERVE} examples x {PASSES} passes in {wall:.2f} s: setup "
            f"{timing['setup_s']:.3f} s, first batch {timing['batch_s'][0]:.3f} s, "
            f"steady {ex_s:.1f} ex/s on {smi}")
        log(f"[serve] PSNR posterior mean {psnr_mean:.3f} dB, sample {psnr_sample:.3f} dB; "
            f"mean ELBO loss {float(loss.mean()):.6g}; std in [{std.min():.3g}, {std.max():.3g}]")
        if not psnr_mean >= PSNR_FLOOR_DB:
            raise AssertionError(f"posterior-mean PSNR {psnr_mean:.2f} dB < {PSNR_FLOOR_DB} dB")
        srv, draws = check_eval_step(cfg, sinos_all[: cfg.batch_size], theta, run, dev)
        profile_eval_step(srv, draws)

        # -- 5. train ----------------------------------------------------
        train_run = os.path.join(tmp, "train_run")
        os.makedirs(os.path.join(train_run, "training_checkpoints"))
        os.symlink(os.path.join(r4, "ckpt-100000.msgpack"),
                   os.path.join(train_run, "training_checkpoints", "ckpt-100000.msgpack"))
        if N_TRAIN != N_SERVE:
            raise AssertionError("the train phase reuses the serving phase's 100 sinograms")
        for k in joseph_radon.LAUNCHES:
            joseph_radon.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        # r4's own flags (config.json: restore, ulc, resume_total, reuse_cache,
        # train), with num_iter 100 past its 100000 steps
        rc = cli.main(["train", "--config", os.path.join(r4, "config.json"),
                       "--input_path", data, "--save_path", train_run, "--td", str(N_TRAIN),
                       "-i", str(100000 + TRAIN_STEPS), "--restore", "--ulc", "--train"])
        wall = time.perf_counter() - t0
        train_launches = dict(joseph_radon.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"cli train returned {rc}")
        eval_batches = N_TRAIN // cfg.batch_size
        per_init_batch = (1 + 30) + 60  # sirt: A1 and 30 iterations; tv: 60 iterations
        init_batches = -(-N_TRAIN // INIT_BATCH)
        expected = {"joseph_fwd": TRAIN_STEPS + eval_batches, "joseph_adj": TRAIN_STEPS,
                    "joseph_fwd_static": per_init_batch * init_batches,
                    "joseph_adj_static": per_init_batch * init_batches}
        log(f"[train] launches {train_launches} (expected {expected}: A and B once per step, "
            f"A once per final-evaluation batch, C and D {per_init_batch} times per init batch "
            f"of {INIT_BATCH})")
        if train_launches != expected:
            raise AssertionError(f"train launches {train_launches}, expected {expected}")
        losses = np.load(os.path.join(train_run, "train_loss_vec.npy"))
        loss_final = np.load(os.path.join(train_run, "loss_final.npy"))
        recon = np.load(os.path.join(train_run, "reconstruction_mean.npy"))
        if losses.shape != (TRAIN_STEPS,) or not np.isfinite(losses).all():
            raise AssertionError(f"train losses: shape {losses.shape} or non-finite values")
        if not np.isfinite(loss_final).all() or recon.shape != (N_TRAIN, n, n, 1):
            raise AssertionError("final evaluation: non-finite loss or wrong shape")
        if not os.path.exists(os.path.join(train_run, "training_checkpoints",
                                           f"ckpt-{100000 + TRAIN_STEPS}.msgpack")):
            raise AssertionError("no checkpoint at the last step")
        psnr_train = mean_psnr(truth, recon[..., 0])
        setup_min = float(np.load(os.path.join(train_run, "setup_time.npy")))
        train_min = float(np.load(os.path.join(train_run, "training_time.npy")))
        log(f"[train] {TRAIN_STEPS} steps from step 100000 in {wall:.2f} s (cli wall): set-up "
            f"{setup_min * 60:.3f} s (masks, Poisson draws, sirt/tv/fbp/gridrec init stack, restore, "
            f"first step), then {TRAIN_STEPS - 1} steps in {train_min * 60:.3f} s = "
            f"{(TRAIN_STEPS - 1) / (train_min * 60):.2f} steps/s (checkpoint writes included) on {smi}")
        log(f"[train] loss first {losses[0]:.6g}, last {losses[-1]:.6g}, mean {losses.mean():.6g}; "
            f"final evaluation loss {loss_final.mean():.6g}; posterior-mean PSNR {psnr_train:.4f} dB")
        if not psnr_train >= PSNR_FLOOR_DB:
            raise AssertionError(f"posterior-mean PSNR {psnr_train:.2f} dB < {PSNR_FLOOR_DB} dB")
        trainer, bidx, aidx = check_train_step(cfg, sinos_all[: cfg.batch_size], theta, train_run, dev)
        profile_train_step(trainer, bidx, aidx)

        # -- 6. gather route: the toy recipe -------------------------------
        toy_yaml = os.path.join(REPO, "configs", "toy.yaml")
        toy_data = os.path.join(REPO, "dataset_toy_discrete2")
        toy_run = os.path.join(tmp, "toy_run")
        toy_cfg = Config.load(toy_yaml)
        toy_sinos, toy_theta, _ = load_dataset(toy_data)
        for k in joseph_radon.LAUNCHES:
            joseph_radon.LAUNCHES[k] = 0
        radon.CALLS["radon"] = 0
        t0 = time.perf_counter()
        rc = cli.main(["train", "--config", toy_yaml, "--input_path", toy_data,
                       "--save_path", toy_run, "-i", str(TOY_STEPS)])
        wall = time.perf_counter() - t0
        toy_launches, gather_calls = dict(joseph_radon.LAUNCHES), radon.CALLS["radon"]
        if rc != 0:
            raise AssertionError(f"cli train (toy) returned {rc}")
        expected_gather = TOY_STEPS + len(toy_sinos) // toy_cfg.batch_size  # + final evaluation
        log(f"[gather] toy recipe (configs/toy.yaml, {len(toy_sinos)} sinograms, "
            f"{len(toy_theta)} angles x {toy_sinos.shape[-1]} pixels, cut to {TOY_STEPS} of "
            f"{toy_cfg.num_iter} steps): gather projector calls {gather_calls} (expected "
            f"{expected_gather}: one per step and per final-evaluation batch), Joseph launches "
            f"{toy_launches}")
        if any(toy_launches.values()) or gather_calls != expected_gather:
            raise AssertionError("the toy recipe did not take the gather route alone")
        losses = np.load(os.path.join(toy_run, "train_loss_vec.npy"))
        loss_final = np.load(os.path.join(toy_run, "loss_final.npy"))
        if losses.shape != (TOY_STEPS,) or not np.isfinite(losses).all() \
                or not np.isfinite(loss_final).all():
            raise AssertionError(f"toy losses: shape {losses.shape} or non-finite values")
        train_min = float(np.load(os.path.join(toy_run, "training_time.npy")))
        log(f"[gather] {TOY_STEPS} steps in {wall:.2f} s (cli wall), {TOY_STEPS - 1} steps in "
            f"{train_min * 60:.3f} s = {(TOY_STEPS - 1) / (train_min * 60):.2f} steps/s on {smi}; "
            f"loss first {losses[0]:.6g}, last {losses[-1]:.6g}; final evaluation loss "
            f"{loss_final.mean():.6g}")
        toy_trainer, bidx, aidx = check_train_step(
            toy_cfg, toy_sinos[: toy_cfg.batch_size], toy_theta, toy_run, dev, label="gather")
        profile_train_step(toy_trainer, bidx, aidx, label="toy train step")

        # -- 7. serve on the real init stack --------------------------------
        for k in joseph_radon.LAUNCHES:
            joseph_radon.LAUNCHES[k] = 0
        real_dir = os.path.join(tmp, "out_real")
        t0 = time.perf_counter()
        rc = cli.main(["infer", "--run_path", run, "--input_path", data, "--output", real_dir,
                       "--passes", str(PASSES)])
        wall = time.perf_counter() - t0
        real_launches = dict(joseph_radon.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"cli infer (real init stack) returned {rc}")
        expected = {"joseph_fwd": -(-N_SERVE // cfg.batch_size) * PASSES, "joseph_adj": 0,
                    "joseph_fwd_static": per_init_batch * -(-N_SERVE // INIT_BATCH),
                    "joseph_adj_static": per_init_batch * -(-N_SERVE // INIT_BATCH)}
        log(f"[serve-real] launches {real_launches} (expected {expected})")
        if real_launches != expected:
            raise AssertionError(f"real-stack serving launches {real_launches}, expected {expected}")
        mean = np.load(os.path.join(real_dir, "reconstruction_mean.npy"))
        loss = np.load(os.path.join(real_dir, "infer_loss.npy"))
        with open(os.path.join(real_dir, "infer_timing.json")) as f:
            timing = json.load(f)
        if mean.shape != (N_SERVE, n, n, 1) or not np.isfinite(mean).all() \
                or not np.isfinite(loss).all():
            raise AssertionError(f"real-stack serving: shape {mean.shape} or non-finite values")
        psnr_real = mean_psnr(truth, mean[..., 0])
        steady = timing["batch_s"][1:]
        log(f"[serve-real] {N_SERVE} examples x {PASSES} passes in {wall:.2f} s: set-up "
            f"{timing['setup_s']:.3f} s (masks, Poisson draws, sirt/tv/fbp/gridrec stack, restore), "
            f"steady {len(steady) * timing['batch_size'] / sum(steady):.1f} ex/s on {smi}; "
            f"PSNR posterior mean {psnr_real:.3f} dB (cheap stack {psnr_mean:.3f} dB, after "
            f"training {psnr_train:.3f} dB)")
        if not psnr_real >= PSNR_FLOOR_DB:
            raise AssertionError(f"posterior-mean PSNR {psnr_real:.2f} dB < {PSNR_FLOOR_DB} dB")

    # -- 8. kernel E and its probe ---------------------------------------
    conv_fused.LAUNCHES["conv_fused_maxout"] = 0
    log("[probe] python -m ct_pvae_tpu_torch.scripts.probe_conv_fused (defaults)")
    rc = probe_conv_fused.main([])
    probe_launches = conv_fused.LAUNCHES["conv_fused_maxout"]
    log(f"[probe] kernel E launches in the probe: {probe_launches}")
    if rc != 0 or probe_launches == 0:
        raise AssertionError(f"the probe returned {rc} with {probe_launches} launches of E")
    x, kern, bias = probe_conv_fused.probe_inputs(10, 128, 40, 40, 3, dev)
    records["conv_fused_maxout"] = check_conv_fused("E probe shape", x, kern, bias, timed=True)
    x, kern, bias = probe_conv_fused.probe_inputs(3, 37, 11, 70, 3, dev)
    check_conv_fused("E ragged", x[:, :, :35].contiguous(), kern, bias, timed=False)
    log("[probe] ok")

    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    meta = {  # A and B run on C's and D's kernels
        "joseph_fwd": ("csrc/joseph_fwd_static.cu", "ct_pvae_tpu/ops/pallas_radon.py:455"),
        "joseph_adj": ("csrc/joseph_adj_static.cu", "ct_pvae_tpu/ops/pallas_radon.py:487"),
        "joseph_fwd_static": ("csrc/joseph_fwd_static.cu", "ct_pvae_tpu/ops/pallas_radon.py:124"),
        "joseph_adj_static": ("csrc/joseph_adj_static.cu", "ct_pvae_tpu/ops/pallas_radon.py:152"),
        "conv_fused_maxout": ("csrc/conv_fused.cu", "scripts/probe_conv_fused.py:97"),
    }
    # A-D: their launches on the train path (phase 5); E: on the probe (phase 8)
    launches = {**train_launches, "conv_fused_maxout": probe_launches}
    kernels = [dict(name=name, route="cuda", source=f"ct_pvae_tpu_torch/{src}", replaces=tpu,
                    launches=launches[name], **records[name])
               for name, (src, tpu) in meta.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
