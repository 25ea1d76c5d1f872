#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ct_pvae_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero:

  1. device  - the card (nvidia-smi name and power limit), torch, CUDA, TF32
  2. build   - nvcc builds every kernel from csrc/, one process per source,
               all started together
  3. kernels - each kernel against its plain PyTorch version at the shapes
               the main paths give it: A (forward) at the serving and the
               training shape, B (adjoint) at the training shape, C and D
               (the static pair) at the init-stack shape; kernel, plain and
               library-call times, the kernel's bound, and <Ax, g> = <x, A^T g>
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
INIT_BATCH = 32          # classical_recon_stack's batch
PSNR_FLOOR_DB = 15.0
KERNEL_RTOL = 1e-5       # relative, plus KERNEL_ATOL_FRAC * max|plain|:
KERNEL_ATOL_FRAC = 1e-5  # the kernel and plain version differ in summation order only
ADJOINT_RTOL = 1e-5      # <Ax, g> against <x, A^T g>, float64 sums of float32 terms
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


def cuda_ms(fn, repeats: int, per_sample: int = 1) -> float:
    """Median over ``repeats`` samples of the device time per call of ``fn()``,
    each sample ``per_sample`` calls queued back to back between two CUDA
    events (after one warm-up call), so that for a short kernel the host's
    launch time hides behind the device's work instead of being timed."""
    import torch

    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    times.sort()
    return times[len(times) // 2]


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


def check_kernel(label, kernel, plain, x, table, n, n_det, adjoint=False):
    """Kernel vs plain version on ``x``, times, bound, and the same function
    as one cuSPARSE product (the projector's CSR matrix, or its transpose
    for an adjoint); returns the kernel's record."""
    import torch

    b = x.shape[0]
    a = table.shape[0]
    got = kernel(x)
    want = plain(x)
    torch.cuda.synchronize()
    err = (got - want).abs()
    scale = float(want.abs().max())
    max_abs = float(err.max())
    bad = int((err > KERNEL_RTOL * want.abs() + KERNEL_ATOL_FRAC * scale).sum())
    log(f"  {label}: {tuple(x.shape)} x {a} angles -> {tuple(got.shape)}; "
        f"max abs err {max_abs:.3e}, max rel err {max_abs / scale:.3e} (of max {scale:.4g}); "
        f"{bad} outside rtol {KERNEL_RTOL:g} + atol {KERNEL_ATOL_FRAC:g}*max")
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: kernel disagrees with its plain version")

    ms = cuda_ms(lambda: kernel(x), 10, per_sample=20)
    plain_ms = cuda_ms(lambda: plain(x), 3)

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
    bytes_moved = (x.numel() + table.numel() + got.numel()) * 4
    ops = 2 * taps + sino_numel  # a multiply-add per in-range tap, one weight scale per ray
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    log(f"  {label}: kernel {ms:.4f} ms (median of 10 x 20 queued launches), plain {plain_ms:.3f} ms, "
        f"cuSPARSE csr@dense {library_ms:.4f} ms (max abs err {lib_err:.2e}); "
        f"bound {bound_ms:.5f} ms by {bound_by} (bytes {bytes_moved} B -> {bound_bytes_ms:.5f} ms "
        f"at 3.35 TB/s; {ops} flops -> {bound_ops_ms:.5f} ms at 67 TFLOP/s; {taps} taps)")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def check_adjoint(label, fwd, adj, x, g) -> None:
    """<fwd(x), g> against <x, adj(g)> on the card."""
    lhs = float((fwd(x).double() * g.double()).sum())
    rhs = float((x.double() * adj(g).double()).sum())
    rel = abs(lhs - rhs) / abs(lhs)
    log(f"  {label}: <Ax, g> {lhs:.10g} vs <x, A^T g> {rhs:.10g} (rel {rel:.2e}, tolerance {ADJOINT_RTOL:g})")
    if not rel <= ADJOINT_RTOL:
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
        srv = Server(eval_cfg, sinos, theta, d)
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


def check_train_step(cfg, sinos, theta, run_path, dev):
    """One train step of the restored r4 model on the card against the port's
    CPU path, on the same params, batch, angles and draws: loss and every
    gradient.  The CPU trainer reads the card's masks, measurements and init
    stack from their cache files.  Returns the card's trainer."""
    import numpy as np
    import torch

    from ct_pvae_tpu_torch.vi.train import Trainer

    tcfg = cfg.replace(save_path=run_path, truncate_dataset=len(sinos), restore=True,
                       use_latest_ckpt=True, reuse_cache=True)
    gpu = Trainer(tcfg, sinos, theta, dev)
    cpu = Trainer(tcfg, sinos, theta, torch.device("cpu"))
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
    log(f"[train] one step GPU vs CPU: loss {l_gpu:.7g} vs {l_cpu:.7g} (rel {rel:.2e}, tolerance "
        f"{CPU_STEP_LOSS_RTOL:g}); gradient error norm / norm: all {len(g_gpu)} tensors together "
        f"{whole:.2e}, largest {', '.join(f'{k} {e:.2e}' for e, k in errs[:3])} "
        f"(tolerance {CPU_GRAD_RTOL:g} each)")
    if not (rel <= CPU_STEP_LOSS_RTOL and errs[0][0] <= CPU_GRAD_RTOL):
        raise AssertionError("GPU train step disagrees with the CPU path")
    return gpu, bidx, aidx


def profile_train_step(tr, bidx, aidx, steps: int = 5) -> dict:
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
    log(f"[profile] train step (batch {cfg.batch_size}, {cfg.angles_per_iter} angles): "
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
    from ct_pvae_tpu_torch.ops import _cuda, joseph_radon

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
    sources = ("joseph_fwd", "joseph_adj")
    _cuda.load_libraries(*sources)
    log(f"[build] {', '.join(f'{n}.cu' for n in sources)} built in parallel and loaded in "
        f"{time.perf_counter() - t0:.2f} s into {_cuda.BUILD_DIR}")

    # -- 3. kernels against their plain versions --------------------------
    jr = joseph_radon
    sinos_all, theta, n_det = load_dataset(os.path.join(REPO, "dataset_foam"))
    cfg = Config.load(os.path.join(REPO, "results", "foam_paper_run_r4", "config.json"))
    n = int(np.floor(n_det / np.sqrt(2) - 2))  # recon size rule: 128 at 184 detectors
    sb = cfg.num_samples * cfg.batch_size      # merged S*B projector batch
    gen = torch.Generator(device=dev).manual_seed(0)
    image = torch.rand((sb, n, n), generator=gen, device=dev)
    table = torch.as_tensor(jr.angle_table_fused(theta, n, n, n_det), device=dev)
    records = {}
    records["joseph_fwd"] = check_kernel(
        "A serving", lambda x: jr.radon_fused(x, table, n_det),
        lambda x: jr.radon_fused_plain(x, table, n_det), image, table, n, n_det)
    sub = table[torch.randperm(len(theta), generator=gen, device=dev)[: cfg.angles_per_iter]].contiguous()
    check_kernel("A training subset", lambda x: jr.radon_fused(x, sub, n_det),
                 lambda x: jr.radon_fused_plain(x, sub, n_det), image, sub, n, n_det)
    g_sub = torch.randn((sb, cfg.angles_per_iter, n_det), generator=gen, device=dev)
    records["joseph_adj"] = check_kernel(
        "B training", lambda g: jr.radon_fused_adjoint(g, sub, n),
        lambda g: jr.radon_fused_adjoint_plain(g, sub, n), g_sub, sub, n, n_det, adjoint=True)
    check_adjoint("A/B training", lambda x: jr.radon_fused(x, sub, n_det),
                  lambda g: jr.radon_fused_adjoint(g, sub, n), image, g_sub)
    theta_f = tuple(float(t) for t in theta)   # the init stack: detector-size images
    full = jr.static_table(theta_f, n_det, n_det, dev)
    img_init = torch.rand((INIT_BATCH, n_det, n_det), generator=gen, device=dev)
    sino_init = torch.rand((INIT_BATCH, len(theta), n_det), generator=gen, device=dev)
    records["joseph_fwd_static"] = check_kernel(
        "C init", lambda x: jr.radon_static(x, theta_f, n_det),
        lambda x: jr.radon_fused_plain(x, full, n_det), img_init, full, n_det, n_det)
    records["joseph_adj_static"] = check_kernel(
        "D init", lambda g: jr.backproject_static(g, theta_f, n_det, n_det),
        lambda g: jr.radon_fused_adjoint_plain(g, full, n_det), sino_init, full, n_det, n_det,
        adjoint=True)
    check_adjoint("C/D init", lambda x: jr.radon_static(x, theta_f, n_det),
                  lambda g: jr.backproject_static(g, theta_f, n_det, n_det), img_init, sino_init)
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
            f"final evaluation loss {loss_final.mean():.6g}; posterior-mean PSNR {psnr_train:.3f} dB")
        if not psnr_train >= PSNR_FLOOR_DB:
            raise AssertionError(f"posterior-mean PSNR {psnr_train:.2f} dB < {PSNR_FLOOR_DB} dB")
        trainer, bidx, aidx = check_train_step(cfg, sinos_all[: cfg.batch_size], theta, train_run, dev)
        profile_train_step(trainer, bidx, aidx)

    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    meta = {
        "joseph_fwd": ("csrc/joseph_fwd.cu", "ct_pvae_tpu/ops/pallas_radon.py:455"),
        "joseph_adj": ("csrc/joseph_adj.cu", "ct_pvae_tpu/ops/pallas_radon.py:487"),
        "joseph_fwd_static": ("csrc/joseph_fwd.cu", "ct_pvae_tpu/ops/pallas_radon.py:124"),
        "joseph_adj_static": ("csrc/joseph_adj.cu", "ct_pvae_tpu/ops/pallas_radon.py:152"),
    }
    kernels = [dict(name=name, route="cuda", source=f"ct_pvae_tpu_torch/{src}", replaces=tpu,
                    launches=train_launches[name], **records[name])
               for name, (src, tpu) in meta.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
