#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ct_pvae_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero:

  1. device  - the card (nvidia-smi name and power limit), torch, CUDA, TF32
  2. build   - nvcc builds every kernel of the serving path from csrc/
  3. kernels - each kernel against its plain PyTorch version at the shapes
               the serving path gives it; kernel, plain and library-call
               times and the kernel's bound
  4. serve   - ``ct_pvae_tpu_torch.cli infer --cheap_init`` on the first 100
               sinograms of dataset_foam with the foam paper run's weights
               (results/foam_paper_run_r4), at full width; launch counts,
               finite outputs, PSNR against the ground truth, and one eval
               step held against the port's CPU path on the same draws

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
PSNR_FLOOR_DB = 15.0
KERNEL_RTOL = 1e-5       # relative, plus KERNEL_ATOL_FRAC * max|plain|:
KERNEL_ATOL_FRAC = 1e-5  # the kernel and plain version differ in summation order only
CPU_EVAL_RTOL = 1e-3     # GPU (cuDNN, no TF32) vs CPU eval step on the same draws


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int) -> float:
    """Median of ``repeats`` CUDA-event timings of ``fn()`` (after one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def check_kernel(label, image, table, n_det, radon_fused, radon_fused_plain):
    """Kernel vs plain version, times, bound; returns the kernel's record."""
    import torch

    b, n, _ = image.shape
    a = table.shape[0]
    got = radon_fused(image, table, n_det)
    want = radon_fused_plain(image, table, n_det)
    torch.cuda.synchronize()
    err = (got - want).abs()
    scale = float(want.abs().max())
    max_abs = float(err.max())
    max_rel = max_abs / scale
    bad = int((err > KERNEL_RTOL * want.abs() + KERNEL_ATOL_FRAC * scale).sum())
    log(f"  {label}: image {tuple(image.shape)} x {a} angles -> {tuple(got.shape)}; "
        f"max abs err {max_abs:.3e}, max rel err {max_rel:.3e} (of max {scale:.4g}); "
        f"{bad} outside rtol {KERNEL_RTOL:g} + atol {KERNEL_ATOL_FRAC:g}*max")
    if bad or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: kernel disagrees with its plain version")

    ms = cuda_ms(lambda: radon_fused(image, table, n_det), 50)
    plain_ms = cuda_ms(lambda: radon_fused_plain(image, table, n_det), 3)

    # library yardstick: the same projection as one cuSPARSE product
    rows, cols, vals = joseph_taps(table, n, n_det)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "sparse CSR support is in beta"
        mat = torch.sparse_coo_tensor(
            torch.stack([rows, cols]), vals, (a * n_det, n * n)
        ).coalesce().to_sparse_csr()
    flat = image.reshape(b, n * n).t().contiguous()
    lib = (mat @ flat).t().reshape(b, a, n_det)
    lib_err = float((lib - want).abs().max())
    library_ms = cuda_ms(lambda: mat @ flat, 20)

    taps = int(rows.numel()) * b
    bytes_moved = (image.numel() + table.numel() + got.numel()) * 4
    ops = 2 * taps + got.numel()  # one multiply-add per in-range tap, one scale per ray
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / FP32_FLOPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    log(f"  {label}: kernel {ms:.4f} ms (median of 50), plain {plain_ms:.3f} ms, "
        f"cuSPARSE csr@dense {library_ms:.4f} ms (max abs err {lib_err:.2e}); "
        f"bound {bound_ms:.5f} ms by {bound_by} (bytes {bytes_moved} B -> {bound_bytes_ms:.5f} ms "
        f"at 3.35 TB/s; {ops} flops -> {bound_ops_ms:.5f} ms at 67 TFLOP/s; {taps} taps)")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


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
    _cuda.load_library("joseph_fwd")
    log(f"[build] joseph_fwd.cu built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_cuda.BUILD_SECONDS['joseph_fwd']:.2f} s) into {_cuda.BUILD_DIR}")

    # -- 3. kernels against their plain versions --------------------------
    sinos_all, theta, n_det = load_dataset(os.path.join(REPO, "dataset_foam"))
    cfg = Config.load(os.path.join(REPO, "results", "foam_paper_run_r4", "config.json"))
    n = int(np.floor(n_det / np.sqrt(2) - 2))  # recon size rule: 128 at 184 detectors
    sb = cfg.num_samples * cfg.batch_size      # merged S*B projector batch
    gen = torch.Generator(device=dev).manual_seed(0)
    image = torch.rand((sb, n, n), generator=gen, device=dev)
    table = torch.as_tensor(joseph_radon.angle_table_fused(theta, n, n, n_det), device=dev)
    serve_rec = check_kernel("serving", image, table, n_det,
                             joseph_radon.radon_fused, joseph_radon.radon_fused_plain)
    sub = torch.randperm(len(theta), generator=gen, device=dev)[: cfg.angles_per_iter]
    check_kernel("training subset", image, table[sub].contiguous(), n_det,
                 joseph_radon.radon_fused, joseph_radon.radon_fused_plain)
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
        expected = -(-N_SERVE // cfg.batch_size) * PASSES
        log(f"[serve] launches {launches} (expected {expected}: 1 per pass per batch)")
        for name, count in launches.items():
            if count == 0:
                raise AssertionError(f"kernel {name} was not launched on the serving path")
        if launches["joseph_fwd"] != expected:
            raise AssertionError(f"joseph_fwd launched {launches['joseph_fwd']} times")

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

    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    record = dict(
        name="joseph_fwd",
        route="cuda",
        source="ct_pvae_tpu_torch/csrc/joseph_fwd.cu",
        replaces="ct_pvae_tpu/ops/pallas_radon.py:455",
        launches=launches["joseph_fwd"],
        **serve_rec,
    )
    print(json.dumps({"kernels": [record]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
