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
               (sirt/tv through C and D), r4's steps_per_call 8 replaying the
               captured train step (A and B inside the graph); launch counts
               (each replay counts what its capture launched), finite losses,
               posterior-mean PSNR of the final evaluation, one train step
               (loss and every gradient) held against the port's CPU path on
               the card step's recorded draws, and a torch.profiler view of
               the eager step
  6. gather  - ``cli train --config configs/toy.yaml`` on dataset_toy_discrete2
               (64 sinograms, a 2-pixel detector), cut to 200 steps in
               graphed chunks of 8: the
               gather projector's calls move and no Joseph kernel launches,
               finite losses, one toy train step held against the CPU path
               and a torch.profiler view of it
  7. serve on the real init stack - ``cli infer`` without ``--cheap_init``
               (sirt/tv through C and D) on phase 4's 100 sinograms with the
               r4 weights; launch counts, set-up seconds, PSNR
  8. kernel E - the probe ``python -m ct_pvae_tpu_torch.scripts.probe_conv_fused``
               at its default shape (its lines and verdict; its launches of E
               are E's count), then E against its plain version at the
               probe's shape and at odd ones (C 11: no 16-byte rows, F 70:
               two pair groups, padded; batch 1 at 5 x 5; a view one float
               into its storage; C 80: ten channel chunks); E timed with the
               host held out in turns with its first design
               (csrc/conv_fused.cu), the plain version, the cuDNN
               formulation in float32 and, as a yardstick only, in TF32;
               its float32 bound beside its 3xTF32 ceiling
  9. stretch - the stretch recipe (configs/foam_stretch.yaml: 512^2 foams,
               a 728-bin detector, 360 angles) at full width, depth cut:
               ``cli make-data`` of 8 of its 64 foams (host foams and
               device sinograms timed apart; kernel C once, no gather
               call; the sinograms against C's plain version) and of the
               toy objects on C (against their analytic sums); ``cli train
               --config configs/foam_stretch.yaml`` for 100 of its 500
               steps (set-up split into masks and the init stack through
               D; A, B and D launches, no gather call; finite losses,
               steps/s, the final evaluation's PSNR, recorded only), one
               stretch step against the CPU path and a profile of it; A,
               B, C and D at the stretch shapes against their plain
               versions, timed with the host held out beside cuSPARSE,
               with their adjoint identities; the ramp FBP of the 8
               sinograms through D against the gather route (PSNR >= 15
               dB on D's) and gridrec_fourier on the card against the CPU
  10. options - from the restored r4 state, 24 steps as three chunks of 8
               replays of the captured train step against 24 eager steps:
               bitwise the same losses and params under cuDNN's
               deterministic algorithms, within 1e-2 in the losses under its
               default ones (beside two eager runs' own spread), launch
               counts (A and B 24 each), then each one's device ms with the
               host held out, wall ms and steps/s in turns;
               ``scripts/step_cost.py`` (its train_graphed rows); then each
               training option from scratch at paper width through ``cli
               train`` for 17 steps (Beta latents and output, --det, dropout
               0.1, InstanceNorm, train_pnm, conv_impl subpixel and im2col,
               bfloat16, profile_steps 3): finite losses, a checkpoint, A
               and B launches; from that checkpoint a chunk of 8 replays of
               the option's captured step against the same 8 eager steps,
               bitwise under cuDNN's deterministic algorithms; one step
               against the CPU path (each tolerance widened by twice a
               yardstick's distance on the card: the step with cuDNN off,
               or in float32 for bfloat16); bfloat16 also under its own
               distance from float32: the loss and the whole gradient
               within it, and each block on the card's input within a
               quarter of its float32 distance from the CPU's block, every
               block but the output head storing bfloat16; the Beta and
               --det runs served through ``cli infer``, the profile run's
               trace
  11. mcmc  - exact-posterior MCMC on phase 5's run (r4's config, masks,
               measurements and real init stack) and phase 6's toy run:
               (a) the image log-prob of example 0 (8 chains, 128^2, 20
               angles -> 184 bins) on the Joseph route, A forward and B
               backward with the chains as their batch axis, against its
               plain version (values 1e-5 relative, gradients 1e-4 of the
               largest) and the gather route (2e-2); each route's
               value-and-grad timed with the host held out; A and B at that
               shape against their plain versions and cuSPARSE; the
               curvature on both routes, finite and positive; (b) ``cli mcmc
               --model foam --chains 8 -b 64 -s 32`` (NUTS on the gather
               route: no A or B launch, the gather projector's calls move;
               adapted step above 1e-5, accept in [0.3, 1]); draws/s, R-hat,
               ESS and both PSNRs; (c) ``cli train --config
               configs/foam_64.yaml -i 1`` on dataset_foam_64, then
               ``run_foam_mcmc`` with scripts/r5_exec.sh's 64^2 recipe cut
               to 64 draws after 192 warm-up (8 chains, depth 5; the Welford
               window and the metric's install kept): step above 1e-3 and
               the posterior mean's PSNR above its init's; (d) ``cli mcmc``
               on the toy run with HMC, NUTS and SMC (-s 160 -b 80): finite
               traces, accept rates in (0.3, 1], SMC at beta 1

  13. sharded - ``cli train --multihost`` on the paper recipe at full width
               from r4's state on 20 sinograms: (a) at world size 1 over
               NCCL (a file store), the save boundary's step and one
               graphed chunk of 8 whose graph holds the gradients'
               all-reduce, against the same 9 steps of one process under
               cuDNN's deterministic algorithms (losses and params within
               1e-6; launches and all-reduces counted), and the same with
               --stream_batches (each replay's examples copied in from host
               memory); (b) two ranks over gloo, both on cuda:0, 4 eager
               steps at --mesh_data 2 and at --mesh_angle 2 against one
               process (losses 1e-5, params within 3e-5 and 99.9% of them
               within 1e-6), each rank's A and B launches, the first fleet
               building the kernels at first use into an empty directory;
               A and B at both fleets' shapes against their plain versions
               and cuSPARSE; the phase's wall and each part's steps/s
  14. the rest of the CLI - (a) ``cli check`` names the card; (b) ``cli
               compare-projectors --n 128 --batch 8 --angles 180``: the
               gather projector's and kernel C's relative errors against the
               C++ oracle (built by ``ct_pvae_tpu_torch/native.py``) within
               tests/test_native.py's 0.02, C's launches, and C at that shape
               against its plain version and cuSPARSE; (c) ``cli
               bench-samplers --model foam`` (128^2, nsa 20, 8 chains: A and
               B with the chains as their batch) with HMC, NUTS and SMC at a
               cut depth: A and B launched, draws/s, each adapted step above
               1e-5 and accept in [0.3, 1]; (d) the same command as two
               gloo ranks on cuda:0 (``--dist_backend gloo``, each command
               joining its own group from the environment and leaving it):
               ``--model toy --devices 2`` with 8 chains, 2 draws after 10
               (HMC with cross-chain adaptation, NUTS with dual averaging,
               the Welford window and the install, SMC resampling across the
               ranks) against one process, and
               (c)'s foam HMC on A and B at each rank's 4 chains against
               (c)'s one process: the diagnostics rank 0 reports and every
               chain's draws and final state on the same seeds (1e-6 of
               each array's largest magnitude), each rank's A and B
               launches; A and B at a rank's share against their plain
               versions and cuSPARSE; (e) ``cli sweep`` on
               configs/hpo_foam.yaml's base and space cut to 10 sinograms,
               3 steps and 2 trials: ``sweep_results.json`` with finite
               losses, then ``--resume`` runs no trial again

The last two lines are the nvidia-smi line and
{"ok": true, "device": {...}}; a line before them holds the per-kernel JSON.
Without a CUDA device the script prints no result and exits 1.
"""

from __future__ import annotations

import contextlib
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
TF32_FLOPS_PER_S = 495e12   # tensor cores; kernel E does three TF32 products per multiply-add

N_SERVE = 100
PASSES = 8
N_TRAIN = 100            # examples the train phase restores onto
TRAIN_STEPS = 100
TOY_STEPS = 200          # the toy recipe's 100,000 steps, cut
INIT_BATCH = 32          # classical_recon_stack's batch
PSNR_FLOOR_DB = 15.0
KERNEL_RTOL = 1e-5       # relative, plus KERNEL_ATOL_FRAC * max|plain|:
KERNEL_ATOL_FRAC = 1e-5  # the kernel and plain version differ in summation order only
                         # (E also in its 3xTF32 split, about 2^-21 of each product)
ADJOINT_RTOL = 1e-6      # <Ax, g> against <x, A^T g>, float64 sums of float32 terms: the
                         # forward and adjoint kernels' taps are bitwise the same
MANY_ANGLES = 1200       # above the 1024 that B and D once took
CPU_EVAL_RTOL = 1e-3     # GPU (cuDNN, no TF32) vs CPU eval step on the same draws
CPU_STEP_LOSS_RTOL = 1e-5  # GPU vs CPU train step: the loss
CPU_GRAD_RTOL = 2e-2       # and each gradient's error norm over its norm: cuDNN runs
                           # some backward convs as float32 FFTs (fft2d_r2c + complex
                           # gemm in the profile), 4.6e-3 at most on an H100
                           # Phase 10 widens each by twice a yardstick's distance
                           # on the card: cuDNN off (InstanceNorm amplifies float32
                           # reordering where a channel's variance is small: 2.7e-2
                           # in one bias on an H100) or, for bfloat16, float32
BF16_FLOOR = 1e-3          # bfloat16 in effect: its step's gradient at least this far
                           # (error norm over norm) from the float32 step's on the card
BF16_STEP_FRAC = 1.0       # bfloat16 on the card against the CPU: the whole gradient
                           # within its distance from the float32 step's, the loss
                           # within 1e-5 plus its own (a rounding that flips cascades
                           # through the model's 20-odd blocks: 0.53-0.75 of them on
                           # an H100)
BF16_BLOCK_FRAC = 0.25     # and each bfloat16 block, on the input the card gave it,
                           # within a quarter of the same block's distance in float32
                           # (tests/test_torch_train_options.py holds the CPU's
                           # bfloat16 blocks to the JAX package's at that fraction)
# the stretch recipe (configs/foam_stretch.yaml): its widths, with depth cut
STRETCH_PIXELS, STRETCH_DETECTOR, STRETCH_ANGLES = 512, 728, 360
STRETCH_FOAMS = 8        # of the recipe's 64: the host rasterises the foams (3-6 s each)
STRETCH_STEPS = 100      # of the recipe's 500
TOY_IMAGES = 64
TOY_ATOL = 1e-6          # toy sinograms on kernel C against the analytic sums
GRIDREC_RTOL = 1e-5      # the tolerance tests/test_torch_recon.py holds gridrec to (of the max)
# phase 10: the training options
GRAPH_STEPS = 24         # graphed (K = 8) against eager (K = 1) from the restored r4 state
GRAPH_DET_TOL = 1e-6     # with cuDNN's deterministic algorithms: their losses (relative) and params
GRAPH_LOSS_RTOL = 1e-2   # with its default ones, whose atomics make two eager runs differ by 5e-5
                         # in a loss over 8 steps and 1e-3 over 24 (H100): their losses
OPT_SINOS = 20           # each option's dataset: the paper recipe's batch twice
OPT_STEPS = 17           # the save boundary's 1-step chunk, then two graphed chunks of 8
OPTIONS = {              # each option's config changes over the paper recipe
    "beta": dict(use_normal=False),
    "det": dict(deterministic=True),
    "dropout": dict(dropout_prob=0.1),
    "instance": dict(norm_type="instance"),
    "train_pnm": dict(train_pnm=True),
    "subpixel": dict(conv_impl="subpixel"),
    "im2col": dict(conv_impl="im2col"),
    "bfloat16": dict(compute_dtype="bfloat16"),
    "profile": dict(profile_steps=3),
}
# phase 11: exact-posterior MCMC
MCMC_CHAINS = 8
MCMC_LP_RTOL = 1e-5      # the log-prob on A and B against its plain version: values (relative)
MCMC_GRAD_TOL = 1e-4     # and gradients (of the gradient's largest entry)
MCMC_ROUTE_RTOL = 2e-2   # the Joseph against the gather route: two discretisations
                         # (tests/test_image_mcmc.py:136)
MCMC_FOAM_ARGS = ("-b", "64", "-s", "32")    # 11b: one warm-up chunk of 64, one draw chunk
MCMC_FOAM_MIN_STEP = 1e-5   # r4's frozen chains adapted to 8.3e-7
# scripts/r5_exec.sh:43-46's 448 draws after 384 cut to one draw chunk after three warm-up
# chunks, the second of which installs the Welford metric
MCMC_64 = dict(number_of_steps=64, burnin=192, num_chains=8, max_depth=5)
MCMC_64_MIN_STEP = 1e-3
TOY_MCMC_ARGS = ("-s", "160", "-b", "80")  # 11d: run_toy_mcmc's 200000 and 50000, cut: NUTS
                                           # trees reach depth 8 here, 236 s at -s 1600 -b 400 (PERF.md)
# phase 12: the evaluation stage
MERIT_FULL_DB = 1.5      # 12a: the full-sinogram row's PSNR within this of the JAX package's
                         # artifact (its rows 0 and 1 depend on the data and the noise only)
PIXEL_REPEATS, PIXEL_SAMPLES = 10000, 100  # 12d: the reference's scale (main_ct_vae.py:648)
PIXEL_NEAR = 0.05        # a draw within this of every pixel of an object counts as that object
FIDELITY_N = 32          # 12e: foams (results/fidelity/fidelity.json has 100)
FIDELITY_DB = 2.0        # its noisy median PSNR within this of that file's
# phase 13: sharded training
SHARD_SINOS = 20         # the paper recipe's batch twice
SHARD_GRAPH_STEPS = 9    # 13a: the save boundary's 1-step chunk, then one graphed chunk of 8
SHARD_STEPS = 4          # 13b: eager steps of each 2-rank fleet
SHARD_LOSS_RTOL = 1e-5   # 13b, two ranks against one process: each rank sums its share of the
                         # step's float32 terms and the all-reduce sums the shares, another order
                         # (cuDNN also picks its algorithms for a batch of 5 at --mesh_data 2)
SHARD_PARAM_TOL = 3e-5   # and params: Adam moves an element by lr (1e-4) times its gradient's
                         # normalised step, so the reduction order's relative rounding of a
                         # gradient (~1e-7) moves it by far less than lr, more only where the
                         # gradient is near zero; 3.3e-6 measured after 4 steps, held to 0.3 lr
SHARD_PARAM_WITHIN = 0.999  # with 99.9% of the params within 1e-6 (99.98% measured)
SHARD_TIMEOUT_S = 240    # a rank's wait: the gloo collectives' own timeout is 120 s
# phase 14: the rest of the CLI
COMPARE_ARGS = ("--n", "128", "--batch", "8", "--angles", "180")  # the JAX command's defaults
ORACLE_REL = 0.02        # a projector against the C++ oracle (tests/test_native.py:36)
BENCH_FOAM_ARGS = ("--steps", "4", "--burnin", "24")  # 14c: the foam defaults' 100 and 100, cut
BENCH_TOY_ARGS = ("--chains", "8", "--steps", "2", "--burnin", "10")  # 14d: the toy defaults' 512
                         # chains, 2000 and 500, cut; NUTS's Welford window [1, 9), its install at 9
FLEET = (("toy", (*BENCH_TOY_ARGS, "--devices", "2")), ("foam", ("--samplers", "hmc", *BENCH_FOAM_ARGS)))
CHAIN_TOL = 1e-6         # 14d: two ranks against one process, of each array's largest magnitude
SWEEP = dict(truncate_dataset=10, num_iter=3)  # 14e: configs/hpo_foam.yaml's 50 and 500, cut
SWEEP_TRIALS = 2


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
    the in-range hat taps of every ray, the weight folded in; built 24
    angles at a time, which bounds the (24, T, N) temporaries."""
    import torch

    dev = table.device
    t = torch.arange(n_det, dtype=torch.float32, device=dev)[None, :, None]
    r = torch.arange(n, dtype=torch.float32, device=dev)[None, None, :]
    rows, cols, vals = [], [], []
    for a0 in range(0, table.shape[0], 24):
        tab = table[a0:a0 + 24]
        col = lambda i: tab[:, i][:, None, None]
        pos = (col(2) + col(0) * t) + col(1) * r                # (chunk, T, N)
        y0 = torch.floor(pos)
        is_y = col(4) > 0.5
        ray = ((a0 + torch.arange(tab.shape[0], device=dev))[:, None, None] * n_det
               + torch.arange(n_det, device=dev)[None, :, None]).expand_as(pos)
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


def bound(bytes_moved: int, ops: int, flops_per_s: float = FP32_FLOPS_PER_S):
    """(bound ms, "bytes" or "operations", its log text): the larger of the
    bytes over the memory rate and the operations over their peak (float32
    outside the tensor cores unless ``flops_per_s`` says otherwise)."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / flops_per_s * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    text = (f"bound {max(bytes_ms, ops_ms):.5f} ms by {by} (bytes {bytes_moved} B -> "
            f"{bytes_ms:.5f} ms at 3.35 TB/s; {ops} flops -> {ops_ms:.5f} ms at "
            f"{flops_per_s / 1e12:g} TFLOP/s)")
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
    """Kernel E against its plain version on ``x``, and its first design
    (``csrc/conv_fused.cu``) too.  With ``timed``: E timed with the host held
    out in turns with its first design (kernel, old, three times; each the
    median of its three medians), the plain version, the cuDNN formulation
    in float32 and, as a yardstick only, with ``cudnn.allow_tf32`` (restored
    after), and E's bounds: float32 on CUDA cores, and the 3xTF32 ceiling
    (three TF32 products a multiply-add, what E does) as ``bound_ms``.
    Returns the kernel's record."""
    import torch

    from ct_pvae_tpu_torch.ops import _cuda, conv_fused
    from ct_pvae_tpu_torch.scripts.probe_conv_fused import f_cudnn

    kernel = lambda: conv_fused.conv3x3_periodic_maxout(x, kern, bias)
    old = lambda: _cuda.conv_fused_maxout(x, kern, bias)
    plain = lambda: conv_fused.conv3x3_periodic_maxout_plain(x, kern, bias)
    library = lambda: f_cudnn(x, kern, bias)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    what = f"{tuple(x.shape)} x {tuple(kern.shape)}, x at {x.data_ptr() % 16} bytes past 16"
    max_abs = compare(label, what, got, want)
    compare(f"{label} (first design)", what, old(), want)
    if not timed:
        return None
    turns = [cuda_time(fn, 10, per_sample=20) for fn in (kernel, old) * 3]
    mid = lambda v: sorted(v)[len(v) // 2]
    ms, host_us = mid([t[0] for t in turns[::2]]), mid([t[1] for t in turns[::2]])
    old_ms, old_us = mid([t[0] for t in turns[1::2]]), mid([t[1] for t in turns[1::2]])
    covered = all(t[2] for t in turns[::2])
    old_covered = all(t[2] for t in turns[1::2])
    plain_ms = cuda_ms(plain, 3)
    lib_err = float((library() - want).abs().max())
    library_ms = cuda_ms(library, 10, per_sample=5)
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_err = float((library() - want).abs().max())
        tf32_ms = cuda_ms(library, 10, per_sample=5)
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    b, h, w, c = x.shape
    f = kern.shape[-1] // 2
    bytes_moved = (x.numel() + kern.numel() + bias.numel() + got.numel()) * 4
    ops = 2 * b * h * w * 9 * c * 2 * f  # a multiply-add per tap, channel and output channel
    f32_ms, _, f32_text = bound(bytes_moved, ops)
    bound_ms, bound_by, tf32_text = bound(bytes_moved, 3 * ops, TF32_FLOPS_PER_S)
    note = lambda ok: "" if ok else " (host in the window)"
    log(f"  {label}: kernel {ms:.4f} ms device{note(covered)}, {host_us:.1f} us host per call "
        f"(medians of 10 x 20 queued launches behind a spin), {ops / ms / 1e9:.2f} TFLOP/s; "
        f"first design {old_ms:.4f} ms{note(old_covered)}, {old_us:.1f} us host: "
        f"{old_ms / ms:.2f}x; in turns, kernel {' / '.join(f'{t[0]:.4f}' for t in turns[::2])} "
        f"ms, first design {' / '.join(f'{t[0]:.4f}' for t in turns[1::2])} ms")
    log(f"  {label}: plain (im2col + matmul) {plain_ms:.4f} ms; cuDNN formulation float32 "
        f"{library_ms:.4f} ms (max abs err {lib_err:.2e}, {library_ms / ms:.2f}x E); cuDNN with "
        f"TF32 (yardstick only) {tf32_ms:.4f} ms (max abs err {tf32_err:.2e})")
    log(f"  {label}: float32 {f32_text}: E at {f32_ms / ms:.1%} of it; 3xTF32 ceiling: "
        f"{tf32_text}: E at {bound_ms / ms:.1%} of it")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, host_us=host_us, covered=covered,
                old_design_ms=old_ms, old_design_covered=old_covered, f32_bound_ms=f32_ms,
                cudnn_tf32_ms=tf32_ms, cudnn_tf32_max_abs_err=tf32_err)


def at_offset(x, offset: int):
    """A contiguous copy of ``x`` whose storage starts ``offset`` floats into
    its allocation (not on 16 bytes for offset 1)."""
    import torch

    flat = torch.zeros(x.numel() + offset, dtype=x.dtype, device=x.device)
    return flat[offset:].view_as(x).copy_(x)


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

    from ct_pvae_tpu_torch.vi.loss import Draws, standard_draws
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
            draws = standard_draws(torch.Generator(device=dev).manual_seed(1), shapes, out_shape,
                                   cfg.num_samples, dev)
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


def check_train_step(cfg, sinos, theta, run_path, dev, label="train", yardstick=None):
    """One train step of a run's restored model on the card against the
    port's CPU path, on the same params, batch, angles and draws: loss and
    every gradient.  The card's step draws from a generator and records its
    draws (normals, uniforms, log-gamma variates, dropout masks); the CPU
    replays them.  The CPU trainer reads the card's masks, measurements and
    init stack from their cache files, and takes the card's projector route.
    ``yardstick``: a second card step on the same draws whose distance from
    the first widens each tolerance by twice that distance, tensor by
    tensor: "cudnn off" (the same float32 function summed in another order,
    PyTorch's own CUDA convolutions in place of cuDNN's), or "float32" (for
    a bfloat16 run: bfloat16's own distance from float32, which widens the
    loss by ``BF16_STEP_FRAC`` of it).  A bfloat16 run must also lie under
    that distance: each block of the card's step, on the input the card
    gave it, within ``BF16_BLOCK_FRAC`` of its own float32 distance from the
    CPU's bfloat16 block (``check_bf16_blocks``), and the whole gradient
    within ``BF16_STEP_FRAC`` of it (and it at least ``BF16_FLOOR``).
    Returns the card's trainer and the step's (batch, angle) indices."""
    import numpy as np
    import torch

    from ct_pvae_tpu_torch.vi.loss import Draws, GeneratorDraws
    from ct_pvae_tpu_torch.vi.train import Trainer

    tcfg = cfg.replace(save_path=run_path, truncate_dataset=len(sinos), restore=True,
                       use_latest_ckpt=True, reuse_cache=True, profile_steps=0)
    cpu_dev = torch.device("cpu")
    gpu = Trainer(tcfg, sinos, theta, dev)
    cpu = Trainer(tcfg, sinos, theta, cpu_dev, kernel_route=True)
    if gpu.joseph != cpu.joseph:
        raise AssertionError("the CPU trainer took another projector route than the card's")
    rng = np.random.default_rng(0)
    bidx = rng.permutation(len(sinos))[: cfg.batch_size]
    aidx = rng.permutation(len(theta))[: cfg.angles_per_iter]
    recorder = GeneratorDraws(torch.Generator(device=dev).manual_seed(gpu.step), dev, record=True)

    def step(tr, draws):
        loss, _, grads = tr.loss_and_grads(bidx, aidx, draws)
        return loss.item(), [g.cpu() for g in grads]

    def replay(d):  # the card's draws on device d
        rec = recorder.recorded(cfg.num_samples)
        on = lambda xs: None if xs is None else [x.to(d) for x in xs]
        return Draws([on(e) for e in rec.eps], on(rec.u), on(rec.log_gamma), on(rec.keep))

    seen = []  # (block, input, output) of each block the card's step runs
    hooks = [blk.register_forward_hook(lambda mod, args, out: seen.append((mod, args[0].detach(),
                                                                           out.detach())))
             for model in gpu.models.values() for blk in model.blocks] if yardstick == "float32" else []
    l_gpu, g_gpu = step(gpu, recorder)
    for h in hooks:
        h.remove()
    l_cpu, g_cpu = step(cpu, replay(cpu_dev))
    names = [f"{m}.{k}" for m, model in gpu.models.items() for k, _ in model.named_parameters()]
    names += ["log_pnm"] * (gpu.log_pnm is not None)
    apart = lambda ga, gb: [float((a - b).norm() / b.norm().clamp_min(1e-30)) for a, b in zip(ga, gb)]
    loss_tol, grad_tol = CPU_STEP_LOSS_RTOL, [CPU_GRAD_RTOL] * len(names)
    if yardstick is not None:
        if yardstick == "float32":
            l_ref, g_ref = step(Trainer(tcfg.replace(compute_dtype="float32"), sinos, theta, dev),
                                replay(dev))
        else:
            torch.backends.cudnn.enabled = False
            try:
                l_ref, g_ref = step(gpu, replay(dev))
            finally:
                torch.backends.cudnn.enabled = True
        yard = apart(g_gpu, g_ref)
        loss_tol += (BF16_STEP_FRAC if yardstick == "float32" else 2) * abs(l_gpu - l_ref) / abs(l_ref)
        grad_tol = [t + 2 * y for t, y in zip(grad_tol, yard)]
        log(f"[{label}] yardstick: the card's step against the card's step with {yardstick}: loss "
            f"rel {abs(l_gpu - l_ref) / abs(l_ref):.2e}, gradients largest "
            f"{', '.join(f'{k} {e:.2e}' for e, k in sorted(zip(yard, names), reverse=True)[:3])}")
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    errs = apart(g_gpu, g_cpu)
    worst = sorted(zip([e / t for e, t in zip(errs, grad_tol)], errs, grad_tol, names), reverse=True)
    whole_apart = lambda ga, gb: float(torch.cat([(a - b).flatten() for a, b in zip(ga, gb)]).norm()
                                       / torch.cat([b.flatten() for b in gb]).norm())
    whole = whole_apart(g_gpu, g_cpu)
    log(f"[{label}] one step GPU vs CPU: loss {l_gpu:.7g} vs {l_cpu:.7g} (rel {rel:.2e}, tolerance "
        f"{loss_tol:.3g}); gradient error norm / norm: all {len(g_gpu)} tensors together "
        f"{whole:.2e}, nearest their tolerance "
        f"{', '.join(f'{k} {e:.2e} (tolerance {t:.3g})' for _, e, t, k in worst[:3])}")
    if yardstick == "float32":
        check_bf16_blocks(seen, label)
    if not (rel <= loss_tol and worst[0][0] <= 1.0):
        raise AssertionError(f"{label}: GPU train step disagrees with the CPU path")
    if yardstick == "float32":
        gap = whole_apart(g_gpu, g_ref)
        log(f"[{label}] bfloat16 under its own distance from float32: all gradients together, the "
            f"card's bfloat16 step from the CPU's {whole:.2e}, from the card's float32 step {gap:.2e} "
            f"(at most {BF16_STEP_FRAC:g} of it, and it at least {BF16_FLOOR:g}); per tensor, the "
            f"largest share of that tensor's own distance "
            f"{max(e / max(y, 1e-30) for e, y in zip(errs, yard)):.2f}")
        if not (gap >= BF16_FLOOR and whole <= BF16_STEP_FRAC * gap):
            raise AssertionError(f"{label}: the card's bfloat16 step is not the CPU's bfloat16 step")
    return gpu, bidx, aidx


def check_bf16_blocks(seen, label: str) -> None:
    """Each block of a bfloat16 step on the card, on the input the card gave
    it, against the same block on the CPU in bfloat16: within
    ``BF16_BLOCK_FRAC`` of the block's distance in float32 (on the card) from
    the CPU's, error norms over norms; every block but the decoder's output
    head hands on bfloat16, the head float32 (at the float32 step's
    tolerance)."""
    import torch
    from torch.func import functional_call

    rows, bad = [], []
    for i, (blk, x, out) in enumerate(seen):
        on_cpu = {k: v.detach().cpu() for k, v in [*blk.named_parameters(), *blk.named_buffers()]}
        dtype = blk.dtype
        with torch.no_grad():
            want = functional_call(blk, on_cpu, (x.cpu(),)).float()
            blk.dtype = torch.float32  # the same block in float32, on the card
            try:
                gap = float((blk(x).float().cpu() - want).norm() / want.norm())
            finally:
                blk.dtype = dtype
        err = float((out.float().cpu() - want).norm() / want.norm())
        head = i == len(seen) - 1
        ok = (out.dtype == torch.float32 and err <= CPU_GRAD_RTOL) if head else \
            (out.dtype == torch.bfloat16 and err <= BF16_BLOCK_FRAC * gap)
        rows.append((err, gap))
        if not ok:
            bad.append((i, str(out.dtype), err, gap))
    frac = max(e / g for e, g in rows[:-1])
    log(f"[{label}] per block (error norm / norm, float32 distance): "
        f"{', '.join(f'{e:.1e}/{g:.1e}' for e, g in rows)}")
    log(f"[{label}] {len(seen)} blocks on the card's inputs, card against CPU in bfloat16: error norm "
        f"/ norm at most {max(e for e, _ in rows[:-1]):.2e}, at most {frac:.3f} of the block's float32 "
        f"distance (tolerance {BF16_BLOCK_FRAC:g}; smallest distance {min(g for _, g in rows[:-1]):.2e}); "
        f"output head float32, {rows[-1][0]:.2e}")
    if bad:
        raise AssertionError(f"{label}: bfloat16 blocks (index, dtype, err, float32 distance): {bad}")


def profile_train_step(tr, bidx, aidx, steps: int = 5, label: str = "train step") -> dict:
    """torch.profiler's device time by kernel over ``steps`` eager train
    steps, against their synchronised wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = tr.cfg

    def step():
        return tr.train_step(bidx, aidx)

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


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms (and no benchmarking) within the block."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def reset_counts() -> None:
    """Set every kernel's launch count and the gather projector's call count to 0."""
    from ct_pvae_tpu_torch.ops import joseph_radon, radon

    for k in joseph_radon.LAUNCHES:
        joseph_radon.LAUNCHES[k] = 0
    radon.CALLS["radon"] = 0


class Timed:
    """Within the block, module attribute ``module.name`` is wrapped so that
    its calls add their wall seconds (the device synchronised) to ``seconds[key]``."""

    def __init__(self, seconds: dict, *targets):
        self.seconds, self.targets, self.saved = seconds, targets, []

    def __enter__(self):
        import torch

        for module, name, key in self.targets:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))
            self.seconds.setdefault(key, 0.0)

            def timed(*args, _fn=fn, _key=key, **kw):
                t0 = time.perf_counter()
                out = _fn(*args, **kw)
                torch.cuda.synchronize()
                self.seconds[_key] += time.perf_counter() - t0
                return out

            setattr(module, name, timed)
        return self.seconds

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def phase_stretch(dev, smi: str, records: dict, keep: str) -> dict:
    """Phase 9: ``make-data`` for the stretch recipe's 512^2 foams on kernel C
    and the toy objects, ``cli train --config configs/foam_stretch.yaml`` at
    full width (A, B, D), one stretch step against the CPU path, A-D at the
    stretch shapes, the FBP through D against the gather route, and
    ``gridrec_fourier`` on the card against the CPU.  Adds a ``stretch``
    record to each of A-D's; returns the path's launches by kernel.  Leaves
    the dataset, its ground truth and the trained run under ``keep`` for
    phase 12, copied before the step check rewrites the run's caches."""
    import numpy as np
    import torch

    from ct_pvae_tpu_torch import cli
    from ct_pvae_tpu_torch.config import Config
    from ct_pvae_tpu_torch.data import io as data_io
    from ct_pvae_tpu_torch.data import sinogram
    from ct_pvae_tpu_torch.data.recon_init import crop_center
    from ct_pvae_tpu_torch.eval.metrics import mean_psnr
    from ct_pvae_tpu_torch.ops import joseph_radon as jr
    from ct_pvae_tpu_torch.ops import radon
    from ct_pvae_tpu_torch.ops.fbp import fbp, filter_sinogram
    from ct_pvae_tpu_torch.ops.gridrec import gridrec
    from ct_pvae_tpu_torch.vi import serve

    yaml = os.path.join(REPO, "configs", "foam_stretch.yaml")
    scfg = Config.load(yaml)
    n, n_det, n_ang = STRETCH_PIXELS, STRETCH_DETECTOR, STRETCH_ANGLES
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stretch_") as tmp:
        # -- 9.1 make-data: foams on the host, sinograms on kernel C ----------
        ds = os.path.join(tmp, "dataset_foam_512")
        reset_counts()
        t0 = time.perf_counter()
        with Timed({}, (sinogram, "generate_foam_images", "host foams"),
                   (sinogram, "images_to_sinograms", "device sinograms")) as secs:
            rc = cli.main(["make-data", "--img-type", "foam", "-n", str(STRETCH_FOAMS),
                           "--num-angles", str(n_ang), "--n-pixel", str(n), "--save-path", ds])
        wall = time.perf_counter() - t0
        make_launches, gather = dict(jr.LAUNCHES), radon.CALLS["radon"]
        expected = {"joseph_fwd": 0, "joseph_adj": 0, "joseph_fwd_static": -(-STRETCH_FOAMS // 64),
                    "joseph_adj_static": 0}
        log(f"[stretch] make-data foam -n {STRETCH_FOAMS} --num-angles {n_ang} --n-pixel {n} in "
            f"{wall:.2f} s: host foams {secs['host foams']:.2f} s, device sinograms "
            f"{secs['device sinograms']:.3f} s; launches {make_launches} (expected {expected}: C once "
            f"per chunk of 64), gather projector calls {gather}")
        if rc != 0 or make_launches != expected or gather:
            raise AssertionError(f"make-data returned {rc}; launches {make_launches}, gather {gather}")
        sinos, theta, p = data_io.load_dataset(ds)
        truth = data_io.load_ground_truth(ds)
        if sinos.shape != (STRETCH_FOAMS, n_ang, n_det) or p != n_det or truth.shape != (STRETCH_FOAMS, n, n) \
                or not np.isfinite(sinos).all() or sinos.min() < 0:
            raise AssertionError(f"make-data wrote sinograms {sinos.shape} and truth {truth.shape}")
        theta_f = tuple(float(t) for t in theta)
        table = jr.static_table(theta_f, n_det, n_det, dev)
        padded = radon.pad_phantom(torch.as_tensor(truth, device=dev), n_det)
        want = jr.radon_fused_plain(padded, table, n_det).clamp_min(0.0)
        compare("C make-data chunk", f"the dataset's {STRETCH_FOAMS} sinograms against the plain version",
                torch.as_tensor(sinos, device=dev), want)
        del padded, want

        toy_ds = os.path.join(tmp, "dataset_toy_card")
        reset_counts()
        rc = cli.main(["make-data", "--img-type", "toy", "-n", str(TOY_IMAGES), "--save-path", toy_ds])
        toy_c, gather = jr.LAUNCHES["joseph_fwd_static"], radon.CALLS["radon"]
        tsinos, _, _ = data_io.load_dataset(toy_ds)
        timgs = data_io.load_ground_truth(toy_ds)
        err = max(float(np.abs(tsinos[:, 0] - timgs.sum(axis=1)).max()),
                  float(np.abs(tsinos[:, 1] - timgs.sum(axis=2)[:, ::-1]).max()))
        log(f"[stretch] make-data toy -n {TOY_IMAGES} on the card: {tsinos.shape} sinograms, C launches "
            f"{toy_c}, gather calls {gather}; against the analytic column and flipped row sums max abs "
            f"err {err:.2e} (tolerance {TOY_ATOL:g})")
        if rc != 0 or toy_c != 1 or gather or tsinos.shape != (TOY_IMAGES, 2, 2) or not err <= TOY_ATOL:
            raise AssertionError("toy make-data on the card is not kernel C's analytic sums")

        # -- 9.2 train the stretch recipe at full width ------------------------
        run = os.path.join(tmp, "stretch_run")
        reset_counts()
        t0 = time.perf_counter()
        with Timed({}, (serve, "create_all_masks", "masks"),
                   (serve, "classical_recon_stack", "init stack")) as setup:
            rc = cli.main(["train", "--config", yaml, "--input_path", ds, "--save_path", run,
                           "-i", str(STRETCH_STEPS)])
        wall = time.perf_counter() - t0
        train_launches, gather = dict(jr.LAUNCHES), radon.CALLS["radon"]
        eval_batches = STRETCH_FOAMS // scfg.batch_size
        init_batch = max(1, min(INIT_BATCH, int(INIT_BATCH * (184.0 / n_det) ** 2)))
        init_launches = 2 * -(-STRETCH_FOAMS // init_batch)  # the gridrec and the mask channels
        expected = {"joseph_fwd": STRETCH_STEPS + eval_batches, "joseph_adj": STRETCH_STEPS,
                    "joseph_fwd_static": 0, "joseph_adj_static": init_launches}
        log(f"[stretch] train launches {train_launches} (expected {expected}: A and B once per step, "
            f"A once per final-evaluation batch, D twice per init batch of {init_batch}), gather "
            f"projector calls {gather}")
        if rc != 0 or train_launches != expected or gather:
            raise AssertionError(f"stretch train returned {rc}; launches {train_launches}, gather {gather}")
        shutil.copytree(ds, os.path.join(keep, "dataset_foam_512"))
        shutil.copy(os.path.join(tmp, "foam_512_training.npy"), keep)
        shutil.copytree(run, os.path.join(keep, "stretch_run"), symlinks=True)
        losses = np.load(os.path.join(run, "train_loss_vec.npy"))
        loss_final = np.load(os.path.join(run, "loss_final.npy"))
        recon = np.load(os.path.join(run, "reconstruction_mean.npy"))
        if losses.shape != (STRETCH_STEPS,) or not np.isfinite(losses).all() \
                or not np.isfinite(loss_final).all() or recon.shape != (STRETCH_FOAMS, n, n, 1) \
                or not np.isfinite(recon).all():
            raise AssertionError(f"stretch train: losses {losses.shape} or recon {recon.shape} not finite")
        setup_min = float(np.load(os.path.join(run, "setup_time.npy")))
        train_min = float(np.load(os.path.join(run, "training_time.npy")))
        psnr_stretch = mean_psnr(truth, recon[..., 0])
        log(f"[stretch] {STRETCH_STEPS} steps of configs/foam_stretch.yaml on {STRETCH_FOAMS} foams in "
            f"{wall:.2f} s (cli wall): set-up {setup_min * 60:.3f} s (masks {setup['masks']:.3f} s, init "
            f"stack through D {setup['init stack']:.3f} s, first step), then {STRETCH_STEPS - 1} steps in "
            f"{train_min * 60:.3f} s = {(STRETCH_STEPS - 1) / (train_min * 60):.2f} steps/s on {smi}")
        log(f"[stretch] loss first {losses[0]:.6g}, last {losses[-1]:.6g}; final evaluation loss "
            f"{loss_final.mean():.6g}; posterior-mean PSNR {psnr_stretch:.3f} dB after {STRETCH_STEPS} "
            f"steps from scratch (recorded, not gated)")
        trainer, bidx, aidx = check_train_step(scfg, sinos[: scfg.batch_size], theta, run, dev,
                                               label="stretch")
        profile_train_step(trainer, bidx, aidx, steps=3, label="stretch train step")
        del trainer

        # -- 9.3 A-D at the stretch shapes --------------------------------------
        gen = torch.Generator(device=dev).manual_seed(9)
        sb = scfg.num_samples * scfg.batch_size
        full = torch.as_tensor(jr.angle_table_fused(theta, n, n, n_det), device=dev)
        full_rows = torch.as_tensor(jr.kernel_rows(full.cpu().numpy()), device=dev)
        sel = torch.randperm(n_ang, generator=gen, device=dev)[: scfg.angles_per_iter]
        rows_sub, sub = full_rows.index_select(0, sel), full.index_select(0, sel)
        x8 = torch.rand((sb, n, n), generator=gen, device=dev)
        g8 = torch.randn((sb, scfg.angles_per_iter, n_det), generator=gen, device=dev)
        stretch = {
            "joseph_fwd": check_kernel(
                "A stretch train", lambda x: jr.radon_fused(x, rows_sub, n_det),
                lambda x: jr.radon_fused_plain(x, sub, n_det), x8, sub, n, n_det),
            "joseph_adj": check_kernel(
                "B stretch train", lambda g: jr.radon_fused_adjoint(g, rows_sub, n),
                lambda g: jr.radon_fused_adjoint_plain(g, sub, n), g8, sub, n, n_det, adjoint=True),
        }
        stretch["joseph_fwd"]["at_360_angles"] = check_kernel(
            "A stretch final evaluation", lambda x: jr.radon_fused(x, full_rows, n_det),
            lambda x: jr.radon_fused_plain(x, full, n_det), x8, full, n, n_det)
        check_adjoint("A/B stretch", lambda x: jr.radon_fused(x, rows_sub, n_det),
                      lambda g: jr.radon_fused_adjoint(g, rows_sub, n), x8, g8)
        del x8, g8
        torch.cuda.empty_cache()
        c_new = lambda x: jr.radon_static(x, theta_f, n_det)
        d_new = lambda g: jr.backproject_static(g, theta_f, n_det, n_det)
        c_plain = lambda x: jr.radon_fused_plain(x, table, n_det)
        d_plain = lambda g: jr.radon_fused_adjoint_plain(g, table, n_det)
        x64 = torch.rand((64, n_det, n_det), generator=gen, device=dev)
        stretch["joseph_fwd_static"] = check_kernel("C stretch make-data", c_new, c_plain, x64, table,
                                                    n_det, n_det)
        for rb in (36, 16):  # the ragged last chunks of 100 foams and of this phase's 16
            xr = x64[:rb].contiguous()
            compare(f"C stretch ragged {rb}", f"{tuple(xr.shape)} x {n_ang} angles", c_new(xr), c_plain(xr))
        g2 = torch.rand((init_batch, n_ang, n_det), generator=gen, device=dev)
        stretch["joseph_adj_static"] = check_kernel("D stretch init", d_new, d_plain, g2, table, n_det,
                                                    n_det, adjoint=True)
        check_adjoint("C/D stretch", c_new, d_new, x64[:init_batch].contiguous(), g2)
        del x64, g2
        torch.cuda.empty_cache()

        # -- 9.4 FBP through D against the gather route; gridrec -----------------
        s_all = torch.as_tensor(sinos, device=dev)
        theta_t = torch.as_tensor(theta, device=dev)
        reset_counts()
        rec_d = fbp(s_all, theta, n_det, n_det)  # host angles: D's route reads them without a sync
        torch.cuda.synchronize()
        fbp_d = jr.LAUNCHES["joseph_adj_static"]
        gather_fbp = lambda: radon.backproject(filter_sinogram(s_all), theta_t, n_det, n_det) * (
            np.pi / (2.0 * n_ang))
        rec_g = gather_fbp()
        d_ms = cuda_ms(lambda: fbp(s_all, theta, n_det, n_det), 3)
        g_ms = cuda_ms(gather_fbp, 3)
        rel = float((rec_d - rec_g).abs().max() / rec_g.abs().max())
        psnr_d = mean_psnr(truth, crop_center(rec_d.cpu().numpy(), n, n))
        psnr_g = mean_psnr(truth, crop_center(rec_g.cpu().numpy(), n, n))
        log(f"[stretch] ramp FBP of the {STRETCH_FOAMS} full sinograms: through D ({fbp_d} launch, "
            f"{d_ms:.3f} ms) against the gather route on the card ({g_ms:.3f} ms): max abs diff / max "
            f"{rel:.3e}; PSNR against the ground truth, D {psnr_d:.3f} dB, gather {psnr_g:.3f} dB "
            f"(floor {PSNR_FLOOR_DB} dB on D's)")
        if fbp_d != 1 or radon.CALLS["radon"] or not psnr_d >= PSNR_FLOOR_DB:
            raise AssertionError(f"FBP through D: {fbp_d} launches, PSNR {psnr_d:.2f} dB")
        del rec_d, rec_g
        gr_gpu = gridrec(s_all[:4], theta_t, n_det, n_det)
        gr_cpu = gridrec(s_all[:4].cpu(), theta_t.cpu(), n_det, n_det)
        gr_rel = float((gr_gpu.cpu() - gr_cpu).abs().max() / gr_cpu.abs().max())
        gr_ms = cuda_ms(lambda: gridrec(s_all[:4], theta_t, n_det, n_det), 3)
        psnr_gr = mean_psnr(truth[:4], crop_center(gr_gpu.cpu().numpy(), n, n))
        log(f"[stretch] gridrec_fourier (scatter: its tables would pass 512 MB) of 4 sinograms on the "
            f"card ({gr_ms:.3f} ms) against the CPU: max abs diff / max {gr_rel:.3e} (tolerance "
            f"{GRIDREC_RTOL:g}); PSNR {psnr_gr:.3f} dB")
        if not gr_rel <= GRIDREC_RTOL:
            raise AssertionError("gridrec on the card disagrees with the CPU path")
    launches = {k: make_launches[k] + train_launches[k] for k in make_launches}
    for name, rec in stretch.items():
        records[name]["stretch"] = dict(rec, launches=launches[name])
    log("[stretch] ok")
    return launches


def graph_runs(tcfg, sinos, theta, dev, bidx, aidx, modes):
    """A trainer restored per ``tcfg``, its step captured, and each mode's
    steps ("graphed": chunks of ``steps_per_call`` replays; "eager": one
    eager step each) on the given indices from that same state: each run's
    rows, params and launches.  Returns (trainer, the modes' calls, capture
    seconds with the warm-up, runs)."""
    import torch

    from ct_pvae_tpu_torch.ops import joseph_radon as jr
    from ct_pvae_tpu_torch.vi.train import Trainer

    tr = Trainer(tcfg, sinos, theta, dev)
    k = tcfg.steps_per_call
    state = [t for slot in tr.slots for t in (slot.param, slot.mu, slot.nu)]
    saved = [t.detach().clone() for t in state]
    host_state = (tr.step, tr.adam_count, tr.kl_anneal)
    fns = {
        "graphed": lambda: torch.cat([tr.train_chunk(bidx[i:i + k], aidx[i:i + k])
                                      for i in range(0, len(bidx), k)]),
        "eager": lambda: torch.stack([tr.train_step(b, a) for b, a in zip(bidx, aidx)]),
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.capture_step()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    runs = []
    for mode in modes:
        with torch.no_grad():
            for t, v in zip(state, saved):
                t.copy_(v)
        tr.step, tr.adam_count, tr.kl_anneal = host_state
        reset_counts()
        rows = fns[mode]()
        runs.append(dict(rows=rows.cpu(), launches=dict(jr.LAUNCHES),
                         params=torch.cat([s.param.detach().flatten() for s in tr.slots]).cpu()))
    return tr, fns, capture_s, runs


def runs_apart(x, y):
    """(max rel loss diff, max abs param diff, share of params within 1e-6)."""
    loss = float(((x["rows"][:, 0] - y["rows"][:, 0]).abs() / y["rows"][:, 0].abs()).max())
    diff = (x["params"] - y["params"]).abs()
    return loss, float(diff.max()), float((diff <= 1e-6).float().mean())


def graphed_is_eager(tcfg, sinos, theta, dev, bidx, aidx, label: str) -> None:
    """Under cuDNN's deterministic algorithms, the replays of the captured
    step and the same eager steps from one state: losses and params within
    ``GRAPH_DET_TOL``, A and B once a step in both."""
    import torch

    torch.backends.cudnn.deterministic = True
    try:
        tr, _, capture_s, (g, e) = graph_runs(tcfg, sinos, theta, dev, bidx, aidx, ("graphed", "eager"))
    finally:
        torch.backends.cudnn.deterministic = False
    del tr
    loss_d, param_d, _ = runs_apart(g, e)
    n = len(bidx)
    expected = {key: n if key in ("joseph_fwd", "joseph_adj") else 0 for key in g["launches"]}
    log(f"[{label}] {n} steps graphed (K = {tcfg.steps_per_call}: {-(-n // tcfg.steps_per_call)} chunks "
        f"of replays; capture with its warm-up {capture_s:.2f} s) against eager (K = 1) with cuDNN's "
        f"deterministic algorithms: losses max rel diff {loss_d:.2e}, params max abs diff "
        f"{param_d:.2e} (tolerance {GRAPH_DET_TOL:g} each); launches graphed {g['launches']}, eager "
        f"{e['launches']} (A and B {n} each, no other)")
    if not (loss_d <= GRAPH_DET_TOL and param_d <= GRAPH_DET_TOL
            and g["launches"] == e["launches"] == expected and torch.isfinite(g["rows"]).all()):
        raise AssertionError(f"{label}: the graphed train step is not the eager step")


def phase_options(dev, smi: str) -> dict:
    """Phase 10: the training options.  From the restored r4 state, 24 steps
    graphed (K = 8, three replayed chunks) against 24 eager steps (K = 1):
    losses, params, launch counts, and each one's device ms with the host
    held out, wall ms and steps/s; ``scripts/step_cost.py``, whose train
    rows include the graphed step.  Then each option trained from scratch at
    paper width through ``cli train`` (graphed chunks, cut where
    ``profile_steps``' trace starts and ends): finite losses, a checkpoint,
    A and B launches; from
    its checkpoint one chunk of 8 replays against the same 8 eager steps
    under cuDNN's deterministic algorithms; one step against the CPU path
    (bfloat16 also under its own distance from float32, step and blocks);
    the Beta and --det runs served through ``cli infer``; the profile run's
    trace.  Returns the graphed and eager numbers."""
    import numpy as np
    import torch

    from ct_pvae_tpu_torch import cli
    from ct_pvae_tpu_torch.config import Config
    from ct_pvae_tpu_torch.data.io import load_dataset
    from ct_pvae_tpu_torch.ops import joseph_radon as jr
    from ct_pvae_tpu_torch.scripts import step_cost
    from ct_pvae_tpu_torch.utils.batching import IndexStream

    r4 = os.path.join(REPO, "results", "foam_paper_run_r4")
    cfg = Config.load(os.path.join(r4, "config.json"))
    sinos_all, theta, _ = load_dataset(os.path.join(REPO, "dataset_foam"))
    k = cfg.steps_per_call
    with tempfile.TemporaryDirectory(prefix="chip_smoke_options_") as tmp:
        # -- 10.1 the graphed step against the eager step ---------------------
        run = os.path.join(tmp, "r4")
        os.makedirs(os.path.join(run, "training_checkpoints"))
        os.symlink(os.path.join(r4, "ckpt-100000.msgpack"),
                   os.path.join(run, "training_checkpoints", "ckpt-100000.msgpack"))
        tcfg = cfg.replace(save_path=run, truncate_dataset=N_TRAIN, restore=True, use_latest_ckpt=True,
                           reuse_cache=False, cheap_init=True)
        streams = [IndexStream(N_TRAIN, cfg.batch_size, cfg.seed + 1),
                   IndexStream(len(theta), cfg.angles_per_iter, cfg.seed + 2)]
        for st in streams:
            st.skip(100000)
        bidx = [streams[0].next() for _ in range(GRAPH_STEPS)]
        aidx = [streams[1].next() for _ in range(GRAPH_STEPS)]
        expected = {"joseph_fwd": GRAPH_STEPS, "joseph_adj": GRAPH_STEPS, "joseph_fwd_static": 0,
                    "joseph_adj_static": 0}

        # cuDNN's deterministic algorithms: the graph must replay the eager
        # step's arithmetic, draws and scalars exactly
        graphed_is_eager(tcfg, sinos_all[:N_TRAIN], theta, dev, bidx, aidx, "options r4")
        # the default algorithms, as training runs them: some backward convs
        # sum with atomics, so two eager runs differ too
        tr, fns, capture_s, (g, e, e2) = graph_runs(tcfg, sinos_all[:N_TRAIN], theta, dev, bidx, aidx,
                                                    ("graphed", "eager", "eager"))
        (loss_g, param_g, within_g), (loss_e, param_e, within_e) = runs_apart(g, e), runs_apart(e2, e)
        log(f"[options] the same with cuDNN's default algorithms (capture {capture_s:.2f} s): graphed "
            f"against eager, losses max rel diff {loss_g:.2e} (tolerance {GRAPH_LOSS_RTOL:g}), params "
            f"max abs diff {param_g:.2e}, {within_g:.2%} within 1e-6; eager against eager {loss_e:.2e}, "
            f"{param_e:.2e}, {within_e:.2%}; launches {g['launches']}")
        if not (loss_g <= GRAPH_LOSS_RTOL and g["launches"] == expected
                and torch.isfinite(g["rows"]).all()):
            raise AssertionError("the graphed train step strays from the eager step")
        graphed, eager = fns["graphed"], fns["eager"]
        # device ms with the host held out, then the walls in turns
        timing = {}
        dev_g, host_g, cov_g = cuda_time(lambda: tr.train_chunk(bidx[:k], aidx[:k]), 5)
        dev_e, host_e, cov_e = cuda_time(lambda: tr.train_step(bidx[0], aidx[0]), 5)
        walls = {"graphed": [], "eager": []}
        for mode in ("graphed", "eager", "eager", "graphed"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (graphed if mode == "graphed" else eager)()
            torch.cuda.synchronize()
            walls[mode].append((time.perf_counter() - t0) * 1e3 / GRAPH_STEPS)
        for mode, dev_ms, host_us, covered in (("graphed", dev_g / k, host_g / k, cov_g),
                                               ("eager", dev_e, host_e, cov_e)):
            wall = min(walls[mode])
            timing[mode] = dict(device_ms=dev_ms, host_ms=host_us / 1e3, covered=covered,
                                wall_ms=walls[mode], steps_per_s=1e3 / wall)
            log(f"[options] {mode} paper train step (batch {cfg.batch_size}, {cfg.angles_per_iter} "
                f"angles): device {dev_ms:.3f} ms with the host held out"
                f"{'' if covered else ' (host in the window)'}, host {host_us / 1e3:.3f} ms to enqueue; "
                f"wall {', '.join(f'{w:.3f}' for w in walls[mode])} ms a step over {GRAPH_STEPS} "
                f"steps in turns = {1e3 / wall:.2f} steps/s at best on {smi}")
        del tr, fns, graphed, eager
        torch.cuda.empty_cache()
        log("[options] python -m ct_pvae_tpu_torch.scripts.step_cost --steps 16 (train_graphed: "
            f"chunks of {k} replays, per step)")
        if step_cost.main(["--steps", "16"]) != 0:
            raise AssertionError("step_cost.py failed")

        # -- 10.2 each option from scratch at paper width ----------------------
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        np.save(os.path.join(data, "x_train_sinograms.npy"), np.asarray(sinos_all[:OPT_SINOS]))
        shutil.copy(os.path.join(REPO, "dataset_foam", "dataset_parameters.npy"), data)
        base = cfg.replace(restore=False, use_latest_ckpt=False, resume_total=False, reuse_cache=False,
                           truncate_dataset=OPT_SINOS, input_path=data)
        eval_batches = OPT_SINOS // cfg.batch_size
        for name, over in OPTIONS.items():
            ocfg = base.replace(**over)
            cfg_path = os.path.join(tmp, f"{name}.json")
            ocfg.save(cfg_path)
            orun = os.path.join(tmp, name)
            reset_counts()
            t0 = time.perf_counter()
            # cuDNN's deterministic algorithms: every run checks the same
            # trained state below (the default ones' atomics gave each run
            # its own 17 steps, and the bfloat16 loss check its own margin)
            with cudnn_deterministic():
                rc = cli.main(["train", "--config", cfg_path, "--save_path", orun, "-i", str(OPT_STEPS)])
            wall = time.perf_counter() - t0
            launches = dict(jr.LAUNCHES)
            losses = np.load(os.path.join(orun, "train_loss_vec.npy"))
            train_min = float(np.load(os.path.join(orun, "training_time.npy")))
            want_ab = (OPT_STEPS + eval_batches, OPT_STEPS)
            ckpt = os.path.join(orun, "training_checkpoints", f"ckpt-{OPT_STEPS}.msgpack")
            log(f"[options] {name} ({over}): {OPT_STEPS} steps from scratch in {wall:.2f} s (cli wall), "
                f"{(OPT_STEPS - 1) / (train_min * 60):.2f} steps/s after the first; loss first "
                f"{losses[0]:.6g}, last {losses[-1]:.6g}; A and B launches "
                f"{launches['joseph_fwd']}, {launches['joseph_adj']} (expected {want_ab})")
            if rc != 0 or losses.shape != (OPT_STEPS,) or not np.isfinite(losses).all() \
                    or not os.path.exists(ckpt) \
                    or (launches["joseph_fwd"], launches["joseph_adj"]) != want_ab:
                raise AssertionError(f"option {name}: rc {rc}, losses {losses}, launches {launches}")
            if name == "profile":
                trace = os.path.join(orun, "profile", "trace.json")
                size = os.path.getsize(trace) if os.path.exists(trace) else 0
                log(f"[options] profile: {trace} written, {size} bytes")
                if size == 0:
                    raise AssertionError("profile_steps left no trace")
            rng = np.random.default_rng(OPT_STEPS)
            graphed_is_eager(ocfg.replace(save_path=orun, restore=True, use_latest_ckpt=True,
                                          reuse_cache=True, profile_steps=0),
                             sinos_all[:OPT_SINOS], theta, dev,
                             [rng.permutation(OPT_SINOS)[: cfg.batch_size] for _ in range(k)],
                             [rng.permutation(len(theta))[: cfg.angles_per_iter] for _ in range(k)],
                             f"options {name}")
            check_train_step(ocfg, sinos_all[: cfg.batch_size], theta, orun, dev, label=f"options {name}",
                             yardstick="float32" if name == "bfloat16" else "cudnn off")
            if name in ("beta", "det"):
                out = os.path.join(tmp, f"{name}_served")
                rc = cli.main(["infer", "--run_path", orun, "--input_path", data, "--output", out,
                               "--cheap_init", "--passes", "2"])
                mean = np.load(os.path.join(out, "reconstruction_mean.npy"))
                std = np.load(os.path.join(out, "reconstruction_std.npy"))
                log(f"[options] {name} served through cli infer: mean {mean.shape}, std in "
                    f"[{std.min():.3g}, {std.max():.3g}]")
                if rc != 0 or mean.shape[0] != OPT_SINOS or not np.isfinite(mean).all():
                    raise AssertionError(f"cli infer of the {name} run failed")
    log("[options] ok")
    return timing


class Returns:
    """Within the block, module attribute ``module.name`` is wrapped so that
    the values it returns are appended to ``values``."""

    def __init__(self, module, name: str):
        self.module, self.name, self.values = module, name, []

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def kept(*args, **kw):
            out = self.fn(*args, **kw)
            self.values.append(out)
            return out

        setattr(self.module, self.name, kept)
        return self.values

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def phase_mcmc(dev, smi: str, records: dict, run: str, data: str, toy_run: str, truth) -> dict:
    """Phase 11: exact-posterior MCMC.  11a: the image log-prob of example 0
    of phase 5's run (20 measured angles, 184 bins, 128^2, r4's pnm) on the
    Joseph route (A forward, B backward, the chains as their batch axis)
    against its plain version and the gather route; A and B at that shape;
    each route's value-and-grad timed with the host held out; the curvature
    on both routes.  11b: ``cli mcmc --model foam`` on phase 5's run (NUTS,
    the gather route).  11c: ``cli train --config configs/foam_64.yaml -i 1``
    and ``run_foam_mcmc`` with scripts/r5_exec.sh's 64^2 recipe.  11d: ``cli
    mcmc`` on phase 6's toy run with HMC, NUTS and SMC.  Adds an ``mcmc``
    record to A's and B's; returns the phase's numbers."""
    import numpy as np
    import torch

    from ct_pvae_tpu_torch import cli
    from ct_pvae_tpu_torch.config import Config
    from ct_pvae_tpu_torch.data import io as data_io
    from ct_pvae_tpu_torch.eval import mcmc_run
    from ct_pvae_tpu_torch.mcmc import image_model as im
    from ct_pvae_tpu_torch.mcmc.draws import value_and_grad
    from ct_pvae_tpu_torch.ops import joseph_radon as jr
    from ct_pvae_tpu_torch.ops import radon
    from ct_pvae_tpu_torch.prob.distributions import EPS

    t_phase = time.perf_counter()
    summary = {}
    # the ground truth where data_io.load_ground_truth finds it, for the PSNRs
    np.save(os.path.join(os.path.dirname(data), f"{os.path.basename(data)}_training.npy"), truth)

    # -- 11a. the Joseph route at the chain batch ----------------------------
    cfg = Config.load(os.path.join(run, "config.json"))
    _, theta, _ = data_io.load_dataset(data)
    mask = np.load(os.path.join(run, "all_masks.npy"))[0]
    used = mask > EPS
    theta_used = np.asarray(theta)[used]
    meas = torch.as_tensor(np.load(os.path.join(run, "all_proj_samples.npy"))[0][used], device=dev)
    mask_used = torch.as_tensor(mask[used], device=dev)
    stack = np.load(os.path.join(run, "all_input_encode.npy"))
    n, n_det, pnm = stack.shape[1], meas.shape[-1], cfg.poisson_noise_multiplier
    init_recon = mcmc_run.amplitude_corrected(stack[0, :, :, 0], meas, theta_used, mask_used)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = im.init_chains_from_recon(init_recon, MCMC_CHAINS, gen, device=dev)
    args = (meas, theta_used, mask_used, pnm, n, n)
    lp_joseph = im.make_image_log_prob(*args, use_pallas=True, device=dev)
    lp_gather = im.make_image_log_prob(*args, use_pallas=False, device=dev)
    lp_plain = im.make_image_log_prob(*(a.cpu() if torch.is_tensor(a) else a for a in args),
                                      use_pallas=True, device="cpu")
    reset_counts()
    v_j, g_j = value_and_grad(lp_joseph, x)
    curv_j = im.estimate_curvature_diag(x.mean(0), *args, gen=gen, use_pallas=True)
    torch.cuda.synchronize()
    route_launches = dict(jr.LAUNCHES)
    v_p, g_p = value_and_grad(lp_plain, x.cpu())
    v_g = lp_gather(x).detach()
    v_err = float(((v_j.cpu() - v_p).abs() / v_p.abs()).max())
    g_err = float((g_j.cpu() - g_p).abs().max() / g_p.abs().max())
    route_rel = float(((v_j - v_g).abs() / v_g.abs()).max())
    log(f"[mcmc] image log-prob of example 0 ({MCMC_CHAINS} chains, {n}^2, {len(theta_used)} angles -> "
        f"{n_det} bins, pnm {pnm:g}) on A and B against the plain version on the CPU: values max rel err "
        f"{v_err:.2e} (tolerance {MCMC_LP_RTOL:g}), gradients max abs err / max {g_err:.2e} (tolerance "
        f"{MCMC_GRAD_TOL:g}); against the gather route max rel diff {route_rel:.2e} (tolerance "
        f"{MCMC_ROUTE_RTOL:g}); launches of one value-and-grad and one curvature {route_launches}")
    if not (v_err <= MCMC_LP_RTOL and g_err <= MCMC_GRAD_TOL and route_rel <= MCMC_ROUTE_RTOL
            and torch.isfinite(g_j).all() and route_launches["joseph_fwd"] == 3
            and route_launches["joseph_adj"] == 2):
        raise AssertionError("the Joseph route's image log-prob disagrees or missed A and B")
    route_ms = {}
    for name, lp in (("joseph", lp_joseph), ("gather", lp_gather)):
        ms, us, covered = cuda_time(lambda: value_and_grad(lp, x), 10, per_sample=5)
        route_ms[name] = dict(device_ms=ms, host_us=us, covered=covered)
        log(f"[mcmc] one value-and-grad of {MCMC_CHAINS} chains on the {name} route: {ms:.4f} ms device"
            f"{'' if covered else ' (host in the window)'}, {us:.1f} us host (medians of 10 x 5 behind "
            f"a spin) on {smi}")
    for name, use_pallas in (("joseph", True), ("gather", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        curv = im.estimate_curvature_diag(x.mean(0), *args, gen=gen, use_pallas=use_pallas)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ok = bool(torch.isfinite(curv).all() and (curv > 0).all())
        route_ms[name]["curvature_s"] = wall
        log(f"[mcmc] estimate_curvature_diag (64 probes) on the {name} route: {wall * 1e3:.2f} ms wall; "
            f"finite and positive {ok}; range [{float(curv.min()):.3g}, {float(curv.max()):.3g}]; "
            f"median |joseph - this| / joseph {float(((curv - curv_j).abs() / curv_j).median()):.2e}")
        if not ok:
            raise AssertionError(f"the curvature on the {name} route is not finite and positive")
    summary["routes"] = route_ms
    table = torch.as_tensor(jr.angle_table_fused(theta_used, n, n, n_det), device=dev)
    rows = torch.as_tensor(jr.kernel_rows(table.cpu().numpy()), device=dev)
    imgs = im.softplus_forward(x).reshape(MCMC_CHAINS, n, n).contiguous()
    g_sino = torch.randn((MCMC_CHAINS, len(theta_used), n_det), generator=gen, device=dev)
    rec_a = check_kernel("A mcmc", lambda v: jr.radon_fused(v, rows, n_det),
                         lambda v: jr.radon_fused_plain(v, table, n_det), imgs, table, n, n_det)
    rec_b = check_kernel("B mcmc", lambda g: jr.radon_fused_adjoint(g, rows, n),
                         lambda g: jr.radon_fused_adjoint_plain(g, table, n), g_sino, table, n, n_det,
                         adjoint=True)
    check_adjoint("A/B mcmc", lambda v: jr.radon_fused(v, rows, n_det),
                  lambda g: jr.radon_fused_adjoint(g, rows, n), imgs, g_sino.abs())
    records["joseph_fwd"]["mcmc"] = dict(rec_a, launches=route_launches["joseph_fwd"],
                                         value_and_grad=route_ms["joseph"])
    records["joseph_adj"]["mcmc"] = dict(rec_b, launches=route_launches["joseph_adj"])

    # -- 11b. cli mcmc --model foam on phase 5's run --------------------------
    reset_counts()
    with Returns(mcmc_run, "run_foam_mcmc") as outs:
        rc = cli.main(["mcmc", "--model", "foam", "--save_path", run, "--chains", str(MCMC_CHAINS),
                       *MCMC_FOAM_ARGS])
    launches, gather = dict(jr.LAUNCHES), radon.CALLS["radon"]
    out = outs[0]
    d = out["diag"]
    mean = np.load(os.path.join(run, "mcmc_posterior_mean.npy"))
    std = np.load(os.path.join(run, "mcmc_posterior_std.npy"))
    log(f"[mcmc] cli mcmc --model foam --chains {MCMC_CHAINS} {' '.join(MCMC_FOAM_ARGS)} (NUTS, max depth 7, "
        f"{n}^2): {out['draws']} draws in {out['seconds']:.2f} s = {out['draws'] / out['seconds']:.3f} draws/s "
        f"on {smi}; step {d['final_step_size']:.4g}, accept {d['accept_rate']:.3f}, R-hat max "
        f"{d['rhat_max']:.3f} median {d['rhat_med']:.3f}, ESS min {d['ess_min']:.1f} median "
        f"{d['ess_med']:.1f}, inv-mass spread 10^{d['inv_mass_spread']:.2f}; PSNR posterior mean "
        f"{out.get('psnr_mcmc', float('nan')):.3f} dB, amplitude-corrected init "
        f"{out.get('psnr_init', float('nan')):.3f} dB; gather calls {gather}, Joseph launches {launches}")
    if rc != 0 or not (np.isfinite(mean).all() and np.isfinite(std).all() and mean.shape == (n, n)) \
            or gather == 0 or launches["joseph_fwd"] or launches["joseph_adj"] \
            or not d["final_step_size"] > MCMC_FOAM_MIN_STEP or not 0.3 <= d["accept_rate"] <= 1.0 \
            or "psnr_mcmc" not in out:
        raise AssertionError(f"cli mcmc --model foam: rc {rc}, diag {d}, launches {launches}, gather {gather}")
    summary["foam128"] = dict(out["diag"], draws=out["draws"], seconds=out["seconds"],
                              psnr_mcmc=out["psnr_mcmc"], psnr_init=out["psnr_init"])

    # -- 11c. the 64^2 convergence check --------------------------------------
    val64 = os.path.join(os.path.dirname(run), "val64")
    rc = cli.main(["train", "--config", os.path.join(REPO, "configs", "foam_64.yaml"), "-i", "1",
                   "--input_path", os.path.join(REPO, "dataset_foam_64"), "--save_path", val64])
    if rc != 0:
        raise AssertionError(f"cli train --config configs/foam_64.yaml returned {rc}")
    out = mcmc_run.run_foam_mcmc(val64, **MCMC_64)
    d = out["diag"]
    log(f"[mcmc] 64^2 ({MCMC_64}): {out['draws']} draws in {out['seconds']:.2f} s = "
        f"{out['draws'] / out['seconds']:.3f} draws/s on {smi}; step {d['final_step_size']:.4g}, accept "
        f"{d['accept_rate']:.3f}, R-hat max {d['rhat_max']:.3f} median {d['rhat_med']:.3f}, ESS min "
        f"{d['ess_min']:.1f} median {d['ess_med']:.1f}; PSNR posterior mean {out['psnr_mcmc']:.3f} dB, "
        f"amplitude-corrected init {out['psnr_init']:.3f} dB (the JAX package's CPU run of the uncut recipe, "
        f"448 draws after 384, its own masks and draws: R-hat max 1.048, ESS 280/1238, 26.23 dB against "
        f"15.24 dB)")
    if not (np.isfinite(out["mean"]).all() and d["final_step_size"] > MCMC_64_MIN_STEP
            and out["psnr_mcmc"] > out["psnr_init"]):
        raise AssertionError(f"the 64^2 posterior: diag {d}, PSNRs {out['psnr_mcmc']}, {out['psnr_init']}")
    summary["foam64"] = dict(out["diag"], draws=out["draws"], seconds=out["seconds"],
                             psnr_mcmc=out["psnr_mcmc"], psnr_init=out["psnr_init"])

    # -- 11d. the toy posterior with each sampler -----------------------------
    trace_path = os.path.join(toy_run, "posterior_prob_trace.npy")
    for sampler in ("hmc", "nuts", "smc"):
        fn = f"{sampler}_sample"
        t0 = time.perf_counter()
        with Returns(mcmc_run, fn) as outs:
            rc = cli.main(["mcmc", "--save_path", toy_run, "--sampler", sampler, *TOY_MCMC_ARGS])
        wall = time.perf_counter() - t0
        diag = mcmc_run._scalar_diag(outs[0][1])
        trace = np.load(trace_path)
        log(f"[mcmc] toy {sampler} ({' '.join(TOY_MCMC_ARGS)}, 8 chains) in {wall:.2f} s on {smi}: trace "
            f"{trace.shape}, pixel means {np.round(trace.mean(0), 4).tolist()}; diag {diag}")
        if rc != 0 or not np.isfinite(trace).all() or (
                sampler != "smc" and not 0.3 < diag["accept_rate"] <= 1.0) or (
                sampler == "smc" and diag["beta"] != 1.0):
            raise AssertionError(f"toy {sampler}: rc {rc}, diag {diag}")
        os.remove(trace_path)
        summary[f"toy_{sampler}"] = dict(diag, seconds=wall, pixel_means=trace.mean(0).tolist())
    log(f"[mcmc] ok in {time.perf_counter() - t_phase:.1f} s")
    return summary


def phase_eval(dev, smi: str, records: dict, tmp: str, data: str) -> dict:
    """Phase 12: the evaluation stage on the runs phases 5, 6 and 9 left
    (copied as training left them).  12a: ``cli merit`` on phase 5's run
    (fbp, then gridrec_fourier) beside the JAX package's artifacts; 12b:
    ``cli merit`` on the stretch run (row 0 through D, row 1 on the gather
    route, held against a loop of fbp), D at that shape against its plain
    version; 12c: ``visualize_arrays`` on phase 5's run (one A launch), its
    eval step against the CPU path on the same draws; 12d: the pixel
    histograms' draws on phase 6's toy run at the reference's 10,000 x 100
    and the analytic posterior; 12e: ``cli fidelity -n 32`` (C launches), C
    at its chunk against its plain version; 12f: the box-plot tables of
    12a's and 12b's merits and the dataset panels.  PNGs where matplotlib
    is installed.  Adds a ``merit`` record to D's and a ``fidelity`` record
    to C's; returns the phase's numbers."""
    import importlib.util

    import numpy as np
    import torch

    from ct_pvae_tpu_torch import cli
    from ct_pvae_tpu_torch.config import Config
    from ct_pvae_tpu_torch.data import io as data_io
    from ct_pvae_tpu_torch.data.toy import X_TRAIN_0, X_TRAIN_1
    from ct_pvae_tpu_torch.eval import boxplot, dataset_viz, merit, pixel_dist, visualize
    from ct_pvae_tpu_torch.ops import joseph_radon as jr
    from ct_pvae_tpu_torch.ops import radon
    from ct_pvae_tpu_torch.ops.fbp import fbp
    from ct_pvae_tpu_torch.vi.loss import Draws, GeneratorDraws
    from ct_pvae_tpu_torch.vi.train import Trainer

    t_phase = time.perf_counter()
    plots = importlib.util.find_spec("matplotlib") is not None
    if not plots:
        log("[eval] matplotlib is not installed on this machine: the eval stage's compute functions "
            "run and are checked; its PNGs are not written")
    summary = {}
    zero = {k: 0 for k in jr.LAUNCHES}
    row_names = ("full", "partial", "P-VAE")

    # -- 12a. cli merit on phase 5's run ----------------------------------------
    run = os.path.join(tmp, "merit_run")
    cfg = Config.load(os.path.join(run, "config.json"))
    n_det = data_io.load_dataset(data)[2]
    for alg in ("fbp", "gridrec_fourier"):
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(["merit", "--input_path", data, "--save_path", run, "--pnm",
                       str(cfg.poisson_noise_multiplier), "--baseline_alg", alg])
        wall = time.perf_counter() - t0
        got = dict(jr.LAUNCHES)
        log(f"[eval] 12a cli merit --baseline_alg {alg} on phase 5's run ({cfg.truncate_dataset} "
            f"examples, {n_det} bins) in {wall:.2f} s: launches {got} (the gather backprojector below "
            f"512 bins)")
        if rc != 0 or got != zero:
            raise AssertionError(f"cli merit ({alg}) returned {rc} with launches {got}")
        summary[f"merit_{alg}_s"] = wall
    rows = np.load(os.path.join(run, "final_ave_merit.npy"))
    rows_gr = np.load(os.path.join(run, "final_ave_merit_gridrec.npy"))
    mean_row = np.load(os.path.join(run, "final_ave_merit_mean.npy"))
    r4 = os.path.join(REPO, "results", "foam_paper_run_r4")
    ref, ref_mean = (np.load(os.path.join(r4, f)) for f in ("final_ave_merit.npy", "final_ave_merit_mean.npy"))
    # the only gridrec artifact is round 2's run (results/foam_paper_run), on
    # dataset_foam as it was before its regeneration: another dataset than
    # r4's, whose full-sinogram fbp row there is itself 0.46 dB above r4's
    r2 = os.path.join(REPO, "results", "foam_paper_run")
    ref_gr, ref_r2 = (np.load(os.path.join(r2, f)) for f in ("final_ave_merit_gridrec.npy",
                                                             "final_ave_merit.npy"))
    for i, name in enumerate(row_names):
        log(f"[eval] 12a {name:8s} PSNR {rows[i, 2]:.3f} dB, SSIM {rows[i, 1]:.4f}, MSE {rows[i, 0]:.3e} "
            f"(fbp); gridrec {rows_gr[i, 2]:.3f} dB | JAX artifacts, 1000 objects: fbp {ref[i, 2]:.3f} dB "
            f"(results/foam_paper_run_r4, the regenerated dataset_foam); gridrec {ref_gr[i, 2]:.3f} dB "
            f"beside fbp {ref_r2[i, 2]:.3f} dB (results/foam_paper_run, round 2's run on dataset_foam "
            f"before its regeneration)")
    log(f"[eval] 12a posterior mean PSNR {mean_row[2]:.3f} dB (JAX artifact {ref_mean[2]:.3f} dB)")
    psnr = rows[:, 2]
    if not psnr[0] > psnr[2] > psnr[1] or not abs(psnr[0] - ref[0, 2]) <= MERIT_FULL_DB:
        raise AssertionError(f"merit PSNRs {psnr} (full > P-VAE > partial, full within "
                             f"{MERIT_FULL_DB} dB of {ref[0, 2]:.2f})")
    summary["merit_r4"] = dict(fbp=rows.tolist(), gridrec=rows_gr.tolist(), mean=mean_row.tolist())

    # -- 12b. cli merit on the stretch run: row 0 through D -------------------
    sdata, srun = os.path.join(tmp, "dataset_foam_512"), os.path.join(tmp, "stretch_run")
    scfg = Config.load(os.path.join(srun, "config.json"))
    n_s = len(np.load(os.path.join(srun, "reconstruction_final.npy"), mmap_mode="r"))
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["merit", "--input_path", sdata, "--save_path", srun, "--pnm",
                   str(scfg.poisson_noise_multiplier)])
    wall = time.perf_counter() - t0
    got, expected = dict(jr.LAUNCHES), {**zero, "joseph_adj_static": -(-n_s // 32)}
    srows = np.load(os.path.join(srun, "final_ave_merit.npy"))
    log(f"[eval] 12b cli merit on the stretch run ({n_s} foams, 512^2, 728 bins, 360 angles) in "
        f"{wall:.2f} s: launches {got} (expected {expected}: D once per chunk of 32 for row 0, none "
        f"for row 1's per-example angles); PSNR full {srows[0, 2]:.3f}, partial {srows[1, 2]:.3f}, "
        f"P-VAE {srows[2, 2]:.3f} dB (floor {PSNR_FLOOR_DB} dB on full)")
    if rc != 0 or got != expected or not srows[0, 2] >= PSNR_FLOOR_DB:
        raise AssertionError(f"stretch merit returned {rc}, launches {got}, PSNRs {srows[:, 2]}")
    summary["merit_stretch"] = dict(rows=srows.tolist(), seconds=wall)
    sinos_s, theta_s, n_det_s = data_io.load_dataset(sdata)
    theta_f = tuple(float(t) for t in theta_s)
    table = jr.static_table(theta_f, n_det_s, n_det_s, dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    g = torch.rand((n_s, len(theta_f), n_det_s), generator=gen, device=dev)
    rec = check_kernel("D merit stretch", lambda x: jr.backproject_static(x, theta_f, n_det_s, n_det_s),
                       lambda x: jr.radon_fused_adjoint_plain(x, table, n_det_s), g, table, n_det_s,
                       n_det_s, adjoint=True)
    records["joseph_adj_static"]["merit"] = dict(rec, launches=got["joseph_adj_static"])
    del g
    used, th_used = merit.measured_angles(np.load(os.path.join(srun, "all_masks.npy"))[:n_s],
                                          np.load(os.path.join(srun, "all_proj_samples.npy"))[:n_s], theta_s)
    u, th = torch.as_tensor(used, device=dev), torch.as_tensor(th_used, device=dev)
    reset_counts()
    batched = fbp(u, th, n_det_s, n_det_s)
    loop = torch.cat([fbp(u[i:i + 1], th[i:i + 1], n_det_s, n_det_s) for i in range(n_s)])
    torch.cuda.synchronize()
    err = float((batched - loop).abs().max() / loop.abs().max())
    log(f"[eval] 12b row 1's FBP ({tuple(u.shape)} at per-example angles -> {n_det_s}^2) against a loop "
        f"over the examples: max abs diff / max {err:.2e}; launches {dict(jr.LAUNCHES)}")
    if dict(jr.LAUNCHES) != zero or not err <= KERNEL_RTOL:
        raise AssertionError("per-example angles: not the gather route, or not the loop's result")
    del u, th, batched, loop
    torch.cuda.empty_cache()

    # -- 12c. visualize on phase 5's run ----------------------------------------
    vcfg = cfg.replace(input_path=data, save_path=run, train=False, restore=True, use_latest_ckpt=True,
                       example_num=0)
    tr = Trainer(vcfg, device=dev)
    recorder = GeneratorDraws(torch.Generator(device=dev).manual_seed(vcfg.seed + 11), dev, record=True)
    reset_counts()
    t0 = time.perf_counter()
    panels = visualize.visualize_arrays(vcfg, tr, recorder)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got, gather = dict(jr.LAUNCHES), radon.CALLS["radon"]
    res = panels["results"]
    log(f"[eval] 12c visualize_arrays (example 0 tiled to {vcfg.batch_size}) in {wall:.3f} s: launches "
        f"{got} (expected A once: (20,128,128) x 180 -> 184), gather calls {gather} (the computed "
        f"sinogram); loss_M_VAE {panels['loss_M_VAE']:.6g}, kl {panels['kl_divergence']:.6g}, loglik "
        f"{panels['loglik']:.6g}; PSNR full {res['full'][2]:.3f}, partial {res['partial'][2]:.3f}, "
        f"sample {res['pvae'][2]:.3f}, mean {res['pvae_mean'][2]:.3f} dB")
    if got != {**zero, "joseph_fwd": 1} or gather != 1 or not res["full"][2] >= PSNR_FLOOR_DB:
        raise AssertionError(f"visualize: launches {got}, gather {gather}, results {res}")
    rec_draws = recorder.recorded(vcfg.num_samples)
    cpu_draws = Draws([[e.cpu() for e in es] for es in rec_draws.eps], [x.cpu() for x in rec_draws.u])
    cpu_panels = visualize.visualize_arrays(vcfg, Trainer(vcfg, device="cpu", kernel_route=True), cpu_draws)
    rel = abs(panels["loss_M_VAE"] - cpu_panels["loss_M_VAE"]) / abs(cpu_panels["loss_M_VAE"])
    log(f"[eval] 12c eval step GPU vs CPU on the same draws: loss {panels['loss_M_VAE']:.7g} vs "
        f"{cpu_panels['loss_M_VAE']:.7g} (rel {rel:.2e}, tolerance {CPU_EVAL_RTOL:g})")
    if not rel <= CPU_EVAL_RTOL:
        raise AssertionError("visualize's eval step on the card disagrees with the CPU path")
    if plots:
        visualize.write_panels(run, panels, vcfg.num_sparse_angles)
    summary["visualize"] = dict(results=res, loss=panels["loss_M_VAE"], seconds=wall, cpu_rel=rel)
    del tr

    # -- 12d. pixel histograms' draws on phase 6's toy run -------------------
    toy_run = os.path.join(tmp, "toy_eval_run")
    tcfg = Config.load(os.path.join(toy_run, "config.json")).replace(
        save_path=toy_run, train=False, restore=True, use_latest_ckpt=True)
    ttr = Trainer(tcfg, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    samples = pixel_dist.collect_pixel_samples(ttr, 0, PIXEL_REPEATS, PIXEL_SAMPLES)
    secs = time.perf_counter() - t0
    got, gather = dict(jr.LAUNCHES), radon.CALLS["radon"]
    h0, h1 = pixel_dist.toy_posterior(ttr, 0, tcfg.poisson_noise_multiplier)
    near = [float((np.abs(samples - x.reshape(-1)) < PIXEL_NEAR).all(axis=1).mean()) for x in (X_TRAIN_0, X_TRAIN_1)]
    log(f"[eval] 12d pixel draws of the toy run: {PIXEL_REPEATS} repeats x {PIXEL_SAMPLES} draws "
        f"(the reference's scale) in {secs:.2f} s on {smi}, {-(-PIXEL_REPEATS // 1000)} eval steps of "
        f"1000 copies: gather calls {gather}, launches {got}; samples {samples.shape}; analytic "
        f"posterior h0 {h0:.6f}, h1 {h1:.6f} (sum {h0 + h1:.8f}); draws within {PIXEL_NEAR} of object 0 "
        f"{near[0]:.4f}, of object 1 {near[1]:.4f}")
    if samples.shape != (PIXEL_REPEATS * PIXEL_SAMPLES, 4) or not np.isfinite(samples).all() \
            or got != zero or gather != -(-PIXEL_REPEATS // 1000) or not abs(h0 + h1 - 1.0) <= 1e-6:
        raise AssertionError(f"pixel draws: shape {samples.shape}, launches {got}, gather {gather}, "
                             f"h {h0}, {h1}")
    if plots:
        pixel_dist.plot_pixel_histograms(toy_run, samples, h0, h1, 0)
    summary["pixel_dist"] = dict(seconds=secs, h=[h0, h1], near=near)
    del ttr, samples

    # -- 12e. cli fidelity: the sinograms on C --------------------------------
    fid_out = os.path.join(tmp, "fidelity")
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["fidelity", "-n", str(FIDELITY_N), "--out", fid_out])
    wall = time.perf_counter() - t0
    got, expected = dict(jr.LAUNCHES), {**zero, "joseph_fwd_static": -(-FIDELITY_N // 25)}
    with open(os.path.join(fid_out, "fidelity.json")) as f:
        fid = json.load(f)
    with open(os.path.join(REPO, "results", "fidelity", "fidelity.json")) as f:
        fid_ref = json.load(f)
    ours = fid["recon"]["noisy_operating_point"]["psnr_median"]
    theirs = fid_ref["recon"]["noisy_operating_point"]["psnr_median"]
    log(f"[eval] 12e cli fidelity -n {FIDELITY_N} in {wall:.2f} s: launches {got} (expected {expected}: C "
        f"once per chunk of 25); noisy median PSNR {ours:.3f} dB, noiseless {fid['recon']['noiseless_floor']['psnr_median']:.3f} "
        f"dB; results/fidelity/fidelity.json (n = {fid_ref['recon']['num']}, the JAX package): {theirs:.3f} dB "
        f"(within {FIDELITY_DB} dB); packer saturation {fid['porosity']['saturation']:.4f}")
    if rc != 0 or got != expected or not abs(ours - theirs) <= FIDELITY_DB:
        raise AssertionError(f"fidelity returned {rc}, launches {got}, noisy median PSNR {ours:.2f} dB")
    theta180 = tuple(float(t) for t in np.linspace(0, np.pi, 180, endpoint=False).astype(np.float32))
    table184 = jr.static_table(theta180, 184, 184, dev)
    x25 = torch.rand((25, 184, 184), generator=gen, device=dev)
    rec = check_kernel("C fidelity", lambda x: jr.radon_static(x, theta180, 184),
                       lambda x: jr.radon_fused_plain(x, table184, 184), x25, table184, 184, 184)
    records["joseph_fwd_static"]["fidelity"] = dict(rec, launches=got["joseph_fwd_static"])
    summary["fidelity"] = dict(seconds=wall, noisy_psnr_median=ours)

    # -- 12f. box-plot tables and dataset panels -------------------------------
    merits = boxplot.load_merits([run, srun])
    table5 = boxplot.five_condition_table(merits, merits)
    medians = boxplot.median_trials(table5)
    _, labels, lines = boxplot.box_plot_table([run, srun])
    panels_ds = dataset_viz.dataset_panels(data, run, None, 0, cfg.num_sparse_angles)
    log(f"[eval] 12f the two merit runs as two trials, each its own uniform pair (no uniform-mask runs "
        f"here): five-condition table {table5.shape}, median trials {({k: v.tolist() for k, v in medians.items()})} "
        f"(none for an even count); three-condition: {' | '.join(lines)}; dataset panels "
        f"{ {k: v[0].shape for k, v in panels_ds.items()} }")
    if table5.shape != (2, 5, 3) or any(len(v) for v in medians.values()) or len(labels) != 3 \
            or panels_ds["ground_truth"][0].shape != (n_det, n_det):
        raise AssertionError("box-plot tables or dataset panels")
    if plots:
        boxplot.make_box_plots([run, srun], os.path.join(tmp, "boxplot"))
        dataset_viz.visualize_dataset(data, run, None, 0, cfg.num_sparse_angles,
                                      out_dir=os.path.join(tmp, "dataset_viz"))
        log("[eval] PNGs written (matplotlib is installed)")
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"[eval] ok in {summary['seconds']:.1f} s")
    return summary


# phase 13: a rank of a 2-rank fleet on the card (``python -c``): cuDNN's
# deterministic algorithms, the kernels built into argv[1], then ``cli``
# with argv[2:]; its last line is a JSON of its launches, all-reduces and builds
SHARD_RANK = """
import json, pathlib, sys
import torch
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
from ct_pvae_tpu_torch import cli
from ct_pvae_tpu_torch.ops import _cuda, joseph_radon
from ct_pvae_tpu_torch.parallel import distributed
_cuda.BUILD_DIR = pathlib.Path(sys.argv[1])
rc = cli.main(sys.argv[2:])
print(json.dumps(dict(rc=rc, launches=joseph_radon.LAUNCHES, all_reduce=distributed.CALLS["all_reduce"],
                      build_s=_cuda.BUILD_SECONDS, device=str(torch.cuda.current_device()))), flush=True)
sys.exit(rc)
"""


def run_params(run: str, step: int):
    """The flat params of ``ckpt-<step>`` of a run."""
    import numpy as np

    from ct_pvae_tpu_torch.utils.flax_msgpack import load_checkpoint

    def flat(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k])]
        return [np.asarray(tree, np.float32).ravel()]

    ckpt = load_checkpoint(os.path.join(run, "training_checkpoints", f"ckpt-{step}.msgpack"))
    return np.concatenate(flat(ckpt["params"]))


def phase_sharded(dev, smi: str, records: dict) -> dict:
    """Phase 13: sharded training on the paper recipe at full width, from
    r4's restored state on the first 20 dataset_foam sinograms.  13a: ``cli
    train --multihost`` at world size 1 over NCCL (a file store), the save
    boundary's step and one graphed chunk of 8 (the all-reduce captured in
    the graph), against the same 9 steps of one process, under cuDNN's
    deterministic algorithms: losses and params within ``GRAPH_DET_TOL``;
    then the same with ``--stream_batches`` (the graphed chunk reads the
    examples each replay's fill copied in from host memory).  13b: two ranks over gloo, both on cuda:0 (one card), 4 eager steps at
    ``--mesh_data 2`` and then at ``--mesh_angle 2``, against the same steps
    of one process; each rank's A and B launches; the first fleet builds
    the kernels at first use into an empty directory, both ranks at once.
    A and B at each fleet's shapes against their plain versions and
    cuSPARSE.  Returns the phase's numbers."""
    import numpy as np
    import torch

    from ct_pvae_tpu_torch import cli
    from ct_pvae_tpu_torch.config import Config
    from ct_pvae_tpu_torch.data.io import load_dataset
    from ct_pvae_tpu_torch.ops import _cuda
    from ct_pvae_tpu_torch.ops import joseph_radon as jr
    from ct_pvae_tpu_torch.parallel import distributed

    t_phase = time.perf_counter()
    summary = {}
    r4 = os.path.join(REPO, "results", "foam_paper_run_r4")
    cfg = Config.load(os.path.join(r4, "config.json"))
    sinos, theta, n_det = load_dataset(os.path.join(REPO, "dataset_foam"))
    n = int(np.floor(n_det / np.sqrt(2) - 2))
    eval_batches = SHARD_SINOS // cfg.batch_size
    caches = ("all_masks.npy", "all_proj_samples.npy", "all_input_encode.npy")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        np.save(os.path.join(data, "x_train_sinograms.npy"), np.asarray(sinos[:SHARD_SINOS]))
        shutil.copy(os.path.join(REPO, "dataset_foam", "dataset_parameters.npy"), data)

        def new_run(name: str, caches_from=None) -> str:
            """A run dir holding r4's checkpoint (and another run's caches)."""
            run = os.path.join(tmp, name)
            os.makedirs(os.path.join(run, "training_checkpoints"))
            os.symlink(os.path.join(r4, "ckpt-100000.msgpack"),
                       os.path.join(run, "training_checkpoints", "ckpt-100000.msgpack"))
            for f in caches if caches_from else ():
                shutil.copy(os.path.join(caches_from, f), run)
            return run

        def args(run: str, steps: int):
            # r4's own flags (restore, ulc, resume_total, reuse_cache, train)
            return ["train", "--config", os.path.join(r4, "config.json"), "--input_path", data,
                    "--save_path", run, "--td", str(SHARD_SINOS), "-i", str(100000 + steps),
                    "--restore", "--ulc", "--train"]

        def result(run: str, steps: int) -> dict:
            losses = np.load(os.path.join(run, "train_loss_vec.npy"))
            train_s = float(np.load(os.path.join(run, "training_time.npy"))) * 60
            return dict(losses=losses, params=run_params(run, 100000 + steps),
                        loss_final=np.load(os.path.join(run, "loss_final.npy")),
                        steps_per_s=(steps - 1) / train_s)

        def apart(x, y):
            loss = float(np.max(np.abs(x["losses"] - y["losses"]) / np.abs(y["losses"])))
            final = float(np.max(np.abs(x["loss_final"] - y["loss_final"]) / np.abs(y["loss_final"])))
            diff = np.abs(x["params"] - y["params"])
            return loss, float(diff.max()), float(np.mean(diff <= 1e-6)), final

        # -- 13a. world size 1 over NCCL, the all-reduce in the graph ----------
        def multihost(name: str, extra):
            """``cli train --multihost`` at world size 1 from r4: (rc, wall
            s, launches, all-reduces, the run's result)."""
            run = new_run(name, caches_from=ref_run)
            os.environ.update(COORDINATOR_ADDRESS=f"file://{os.path.join(tmp, name + '.store')}",
                              NUM_PROCESSES="1", PROCESS_ID="0")
            reset_counts()
            distributed.CALLS["all_reduce"] = 0
            t0 = time.perf_counter()
            try:
                rc = cli.main(args(run, SHARD_GRAPH_STEPS) + ["--multihost"] + extra)
            finally:
                for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
                    os.environ.pop(var)
            wall = time.perf_counter() - t0
            return rc, wall, dict(jr.LAUNCHES), distributed.CALLS["all_reduce"], result(run, SHARD_GRAPH_STEPS)

        with cudnn_deterministic():
            ref_run = new_run("one_graphed")
            reset_counts()
            t0 = time.perf_counter()
            rc = cli.main(args(ref_run, SHARD_GRAPH_STEPS))
            ref_wall = time.perf_counter() - t0
            ref = result(ref_run, SHARD_GRAPH_STEPS)
            fleets = {"": multihost("multihost", []),
                      " --stream_batches": multihost("streamed", ["--stream_batches"])}
        want = {"joseph_fwd": SHARD_GRAPH_STEPS + eval_batches, "joseph_adj": SHARD_GRAPH_STEPS,
                "joseph_fwd_static": 0, "joseph_adj_static": 0}
        want_reduces = SHARD_GRAPH_STEPS + eval_batches  # a step's gradients and row; an eval batch's loss
        for flag, (rc_mh, mh_wall, launches, reduces, mh) in fleets.items():
            loss_d, param_d, _, final_d = apart(mh, ref)
            log(f"[sharded] 13a cli train --multihost{flag} at world size 1 (NCCL, file store) from r4's "
                f"state, {SHARD_GRAPH_STEPS} steps (the save boundary's 1, then one graphed chunk of 8 "
                f"replays holding the all-reduce) on {SHARD_SINOS} sinograms, against one process, cuDNN "
                f"deterministic: losses max rel diff {loss_d:.2e}, params max abs diff {param_d:.2e}, final "
                f"evaluation {final_d:.2e} (tolerance {GRAPH_DET_TOL:g}); launches {launches} (expected "
                f"{want}), all-reduces {reduces} (expected {want_reduces}); {mh['steps_per_s']:.2f} "
                f"steps/s after the first ({mh_wall:.2f} s cli wall), one process "
                f"{ref['steps_per_s']:.2f} ({ref_wall:.2f} s) on {smi}")
            if not (rc == rc_mh == 0 and loss_d <= GRAPH_DET_TOL and param_d <= GRAPH_DET_TOL
                    and final_d <= GRAPH_DET_TOL and launches == want and reduces == want_reduces):
                raise AssertionError(f"13a: the multihost{flag} graphed steps are not the one-process steps")
            summary["13a" + flag.replace(" --", "_")] = dict(
                steps_per_s=mh["steps_per_s"], one_process_steps_per_s=ref["steps_per_s"],
                loss_rel=loss_d, param_abs=param_d, wall_s=mh_wall)

        # -- 13b. two gloo ranks on cuda:0 ------------------------------------
        with cudnn_deterministic():
            one_run = new_run("one_eager", caches_from=ref_run)
            rc = cli.main(args(one_run, SHARD_STEPS))
        one = result(one_run, SHARD_STEPS)
        if rc != 0:
            raise AssertionError(f"13b: the one-process run returned {rc}")
        shapes = {}
        # the first fleet builds A's and B's libraries into an empty directory
        for axis, build in (("data", os.path.join(tmp, "build")), ("angle", str(_cuda.BUILD_DIR))):
            run = new_run(f"fleet_{axis}", caches_from=ref_run)
            env = {k: v for k, v in os.environ.items()
                   if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
            env.update(PYTHONPATH=REPO, NUM_PROCESSES="2",
                       COORDINATOR_ADDRESS=f"file://{os.path.join(tmp, axis + '.store')}")
            cmd = [sys.executable, "-c", SHARD_RANK, build, *args(run, SHARD_STEPS), "--multihost",
                   "--dist_backend", "gloo", f"--mesh_{axis}", "2"]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(cmd, cwd=REPO, env={**env, "PROCESS_ID": str(r), "LOCAL_RANK": str(r)},
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for r in range(2)]
            outs = []
            try:
                for p in procs:
                    outs.append(p.communicate(timeout=SHARD_TIMEOUT_S)[0])
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            wall = time.perf_counter() - t0
            for r, (p, out) in enumerate(zip(procs, outs)):
                if p.returncode != 0:
                    raise AssertionError(f"13b --mesh_{axis} 2: rank {r} exited {p.returncode}:\n{out[-6000:]}")
            ranks = [json.loads([ln for ln in out.splitlines() if ln.startswith('{"rc"')][-1])
                     for out in outs]
            eager_line = all("every step runs eagerly" in out for out in outs)
            got = result(run, SHARD_STEPS)
            loss_d, param_d, within, final_d = apart(got, one)
            per_rank = {"joseph_fwd": SHARD_STEPS + eval_batches, "joseph_adj": SHARD_STEPS,
                        "joseph_fwd_static": 0, "joseph_adj_static": 0}
            builds = [r["build_s"] for r in ranks]
            log(f"[sharded] 13b cli train --multihost --dist_backend gloo --mesh_{axis} 2: two ranks on "
                f"cuda:{ranks[0]['device']} and cuda:{ranks[1]['device']}, {SHARD_STEPS} eager steps from r4's "
                f"state (the gloo rule logged by both ranks: {eager_line}) against one process, cuDNN "
                f"deterministic: losses max rel diff {loss_d:.2e} (tolerance {SHARD_LOSS_RTOL:g}), params max "
                f"abs diff {param_d:.2e} (tolerance {SHARD_PARAM_TOL:g}), {within:.2%} within 1e-6 "
                f"(at least {SHARD_PARAM_WITHIN:.1%}), "
                f"final evaluation {final_d:.2e} (tolerance {SHARD_LOSS_RTOL:g}); launches per rank "
                f"{[r['launches'] for r in ranks]} (expected {per_rank} each), all-reduces "
                f"{[r['all_reduce'] for r in ranks]}; builds at first use {builds}; "
                f"{got['steps_per_s']:.2f} steps/s after the first, fleet wall {wall:.2f} s "
                f"(one process {one['steps_per_s']:.2f} steps/s) on {smi}")
            if not (loss_d <= SHARD_LOSS_RTOL and param_d <= SHARD_PARAM_TOL and within >= SHARD_PARAM_WITHIN
                    and final_d <= SHARD_LOSS_RTOL
                    and all(r["launches"] == per_rank for r in ranks) and eager_line
                    and ranks[0]["device"] == ranks[1]["device"] == "0"):
                raise AssertionError(f"13b --mesh_{axis} 2: the two ranks are not the one-process run")
            if axis == "data" and not any(b.get("joseph_fwd_static", 0) > 0 for b in builds):
                raise AssertionError("13b: no rank built the kernels at first use")
            summary[f"13b_{axis}"] = dict(steps_per_s=got["steps_per_s"], wall_s=wall, loss_rel=loss_d,
                                          param_abs=param_d, within_1e6=within,
                                          launches_per_rank=ranks[0]["launches"])
            shapes[axis] = ranks[0]["launches"]
        summary["one_process_eager_steps_per_s"] = one["steps_per_s"]

    # -- A and B at the fleets' shapes --------------------------------------
    gen = torch.Generator(device=dev).manual_seed(13)
    table = torch.as_tensor(jr.angle_table_fused(np.asarray(theta, np.float32), n, n, n_det), device=dev)
    rows = torch.as_tensor(jr.kernel_rows(table.cpu().numpy()), device=dev)
    aidx = torch.randperm(len(theta), generator=gen, device=dev)[: cfg.angles_per_iter]
    sb = cfg.num_samples * cfg.batch_size
    for axis, batch, angles in (("data", sb // 2, aidx), ("angle", sb, aidx[: len(aidx) // 2])):
        rows_sub, sub = rows.index_select(0, angles), table.index_select(0, angles)
        x = torch.rand((batch, n, n), generator=gen, device=dev)
        g = torch.randn((batch, len(angles), n_det), generator=gen, device=dev)
        rec_a = check_kernel(f"A mesh_{axis} 2", lambda v: jr.radon_fused(v, rows_sub, n_det),
                             lambda v: jr.radon_fused_plain(v, sub, n_det), x, sub, n, n_det)
        rec_b = check_kernel(f"B mesh_{axis} 2", lambda v: jr.radon_fused_adjoint(v, rows_sub, n),
                             lambda v: jr.radon_fused_adjoint_plain(v, sub, n), g, sub, n, n_det,
                             adjoint=True)
        check_adjoint(f"A/B mesh_{axis} 2", lambda v: jr.radon_fused(v, rows_sub, n_det),
                      lambda v: jr.radon_fused_adjoint(v, rows_sub, n), x, g.abs())
        # launches per rank at this shape: one a train step (the final
        # evaluation's are at all of the rank's angles)
        records["joseph_fwd"][f"mesh_{axis}"] = dict(rec_a, launches=shapes[axis]["joseph_adj"])
        records["joseph_adj"][f"mesh_{axis}"] = dict(rec_b, launches=shapes[axis]["joseph_adj"])
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"[sharded] ok in {summary['seconds']:.1f} s: 13a {summary['13a']['steps_per_s']:.2f} steps/s "
        f"({summary['13a_stream_batches']['steps_per_s']:.2f} streamed), "
        f"13b --mesh_data 2 {summary['13b_data']['steps_per_s']:.2f}, --mesh_angle 2 "
        f"{summary['13b_angle']['steps_per_s']:.2f} steps/s on {smi}")
    return summary

FLEET_RANK = """
import json, os, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import chip_smoke
store, res = os.environ["COORDINATOR_ADDRESS"], {}
for model, argv in chip_smoke.FLEET:
    os.environ["COORDINATOR_ADDRESS"] = f"{store}.{model}"  # each command joins a group of its own
    res[model] = chip_smoke.bench_cli(model, [*argv, "--dist_backend", "gloo"])
np.savez(f"{sys.argv[2]}.{os.environ['PROCESS_ID']}.npz",
         **{f"{m}.{k}": v for m, r in res.items() for k, v in r.pop("arrays").items()})
print(json.dumps(res), flush=True)
"""


def bench_cli(model: str, argv) -> dict:
    """``cli bench-samplers --model MODEL ARGV`` with every launch count set to
    0 first: its exit code, the rounds it timed (those this rank ran), the
    kernels' launches, each sampler's last call's launches and the device
    of its chains, and as ``arrays`` that call's draws and final states
    (``{sampler}.samples`` / ``.final_state``: this rank's chains)."""
    import torch

    from ct_pvae_tpu_torch import cli
    from ct_pvae_tpu_torch.eval import bench_samplers
    from ct_pvae_tpu_torch.ops import joseph_radon as jr

    calls, saved = {}, {n: getattr(bench_samplers, n) for n in ("hmc_sample", "nuts_sample", "smc_sample")}

    def watch(name, fn):
        def run(*args, **kw):
            before = dict(jr.LAUNCHES)
            samples, diag = fn(*args, **kw)
            calls[name[:-len("_sample")]] = (samples, samples if name == "smc_sample" else diag["final_state"],
                                             {k: jr.LAUNCHES[k] - before[k] for k in before})
            return samples, diag
        return run

    reset_counts()
    try:
        for name, fn in saved.items():
            setattr(bench_samplers, name, watch(name, fn))
        with Returns(bench_samplers, "run_round") as rounds:
            rc = cli.main(["bench-samplers", "--model", model, *argv])
    finally:
        for name, fn in saved.items():
            setattr(bench_samplers, name, fn)
    arrays = {}
    for s_name, (samples, final, _) in calls.items():
        arrays[f"{s_name}.samples"] = samples.detach().cpu().numpy()
        arrays[f"{s_name}.final_state"] = final.detach().cpu().numpy()
    return dict(rc=rc, rounds=[r for r in rounds if r is not None], launches=dict(jr.LAUNCHES),
                calls={k: dict(launches=c[2], device=str(c[0].device)) for k, c in calls.items()},
                arrays=arrays)


def _rel_diff(got, want) -> float:
    import numpy as np

    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want))) / max(1.0, float(np.max(np.abs(want))))


def phase_rest(dev, smi: str, records: dict, tmp: str) -> dict:
    """Phase 14: the rest of the CLI.  14a ``cli check``; 14b ``cli
    compare-projectors`` (the gather projector and kernel C against the C++
    oracle, C at that shape against its plain version); 14c ``cli
    bench-samplers --model foam`` (A and B at the chain batch); 14d two gloo
    ranks on cuda:0 running ``cli bench-samplers`` against one process,
    A and B at a rank's share; 14e ``cli sweep`` and ``--resume``.  Adds C's
    ``compare_projectors`` record and A's and B's ``chains_rank`` records;
    returns the phase's numbers."""
    import io
    import re

    import numpy as np
    import torch

    from ct_pvae_tpu_torch import cli
    from ct_pvae_tpu_torch.eval import bench_samplers
    from ct_pvae_tpu_torch.mcmc.image_model import softplus_forward
    from ct_pvae_tpu_torch.ops import joseph_radon as jr
    from ct_pvae_tpu_torch.vi import train as train_mod

    t_phase = time.perf_counter()
    summary = {}
    # -- 14a. cli check ---------------------------------------------------------
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["check"])
    for line in buf.getvalue().splitlines():
        log(f"[rest] 14a check: {line}")
    name = torch.cuda.get_device_name(0)
    if rc != 0 or name not in buf.getvalue() or "H100" not in buf.getvalue() \
            or "native C++ library: available" not in buf.getvalue():
        raise AssertionError(f"14a: cli check returned {rc} or did not name the card and the native library")

    # -- 14b. cli compare-projectors ------------------------------------------
    reset_counts()
    with Returns(cli, "compare_projectors") as outs:
        rc = cli.main(["compare-projectors", *COMPARE_ARGS])
    c_launches = jr.LAUNCHES["joseph_fwd_static"]
    out = outs[0]
    errs, ms = out["rel_err"], out["ms"]
    log(f"[rest] 14b cli compare-projectors {' '.join(COMPARE_ARGS)}: gather {ms['gather projector']:.3f} ms, "
        f"kernel C {ms[out['c_label']]:.3f} ms (host clock, synchronised, 10 calls), C++ oracle "
        f"{ms.get('oracle', float('nan')):.1f} ms (host); against the oracle: gather {errs.get('gather')}, C "
        f"{errs.get('joseph')} (tolerance {ORACLE_REL}); C launches {c_launches} (expected 11: a warm-up "
        f"and 10 timed) on {smi}")
    if rc != 0 or not (errs.get("gather", 1.0) <= ORACLE_REL and errs.get("joseph", 1.0) <= ORACLE_REL) \
            or c_launches != 11:
        raise AssertionError(f"14b: compare-projectors rc {rc}, errors {errs}, C launches {c_launches}")
    padded, n_det = out["padded"].contiguous(), out["n_det"]
    theta_c = tuple(np.linspace(0, np.pi, int(COMPARE_ARGS[5]), endpoint=False).tolist())
    full = jr.static_table(theta_c, n_det, n_det, dev)
    rec_c = check_kernel("C compare-projectors", lambda x: jr.radon_static(x, theta_c, n_det),
                         lambda x: jr.radon_fused_plain(x, full, n_det), padded, full, n_det, n_det)
    records["joseph_fwd_static"]["compare_projectors"] = dict(rec_c, launches=c_launches)
    summary["14b"] = dict(ms=ms, rel_err=errs, c_launches=c_launches)

    # -- 14c. cli bench-samplers --model foam ---------------------------------
    t0 = time.perf_counter()
    one_foam = bench_cli("foam", BENCH_FOAM_ARGS)
    wall = time.perf_counter() - t0
    launches, res = one_foam["launches"], one_foam["rounds"][0]
    for s_name, r in res.items():
        d = r["diag"]
        accept = d.get("accept_rate", d.get("last_accept"))
        log(f"[rest] 14c bench-samplers --model foam {' '.join(BENCH_FOAM_ARGS)} {s_name}: "
            f"{r['draws_per_s']:.3f} draws/s ({r['draws']} draws in {r['seconds']:.2f} s, {MCMC_CHAINS} chains), "
            f"step {d['final_step_size']:.4g}, accept {accept:.3f}; diag {d} on {smi}")
        if not (d["final_step_size"] > MCMC_FOAM_MIN_STEP and 0.3 <= accept <= 1.0):
            raise AssertionError(f"14c: {s_name} adapted step or accept out of range: {d}")
    log(f"[rest] 14c launches {launches} (A and B at the chain batch of {MCMC_CHAINS}; C once for the "
        f"foam's sinogram) in {wall:.1f} s")
    if one_foam["rc"] != 0 or not launches["joseph_fwd"] or not launches["joseph_adj"] \
            or launches["joseph_fwd_static"] != 1 or set(res) != {"hmc", "nuts", "smc"}:
        raise AssertionError(f"14c: bench-samplers rc {one_foam['rc']}, launches {launches}")
    summary["14c"] = dict(wall_s=wall, launches=launches,
                          **{k: dict(draws_per_s=r["draws_per_s"], seconds=r["seconds"], diag=r["diag"])
                             for k, r in res.items()})

    # -- 14d. the same command as two gloo ranks on cuda:0 against one process -----
    fleet_path = os.path.join(tmp, "fleet")
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    env.update(PYTHONPATH=REPO, NUM_PROCESSES="2",
               COORDINATOR_ADDRESS=f"file://{os.path.join(tmp, 'chains.store')}")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", FLEET_RANK, REPO, fleet_path], cwd=REPO,
                              env={**env, "PROCESS_ID": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        one_toy = bench_cli("toy", BENCH_TOY_ARGS)
        logs = [p.communicate(timeout=SHARD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"14d: rank {r} exited {p.returncode}:\n{text[-6000:]}")
    ranks = [json.loads([ln for ln in text.splitlines() if ln.startswith('{"toy"')][-1]) for text in logs]
    arrays = []
    for r in range(2):
        with np.load(f"{fleet_path}.{r}.npz") as z:
            arrays.append({k: z[k] for k in z.files})
    worst, devices, problems = {}, set(), []
    for model, one in (("toy", one_toy), ("foam", one_foam)):
        fleet = [rk[model] for rk in ranks]
        if any(f["rc"] != 0 for f in fleet):
            problems.append(f"{model}: exit codes {[f['rc'] for f in fleet]}")
        if [sorted({x["ranks"] for x in rnd.values()}) for rnd in fleet[0]["rounds"]] != [[2]]:
            problems.append(f"{model}: rank 0's rounds {fleet[0]['rounds']}")
            continue
        two = fleet[0]["rounds"][0]
        for s_name, r in two.items():
            want = one["rounds"][0][s_name]
            diffs = {k: _rel_diff(r["diag"][k], v) for k, v in want["diag"].items()}
            for part in ("samples", "final_state"):
                axis = 1 if part == "samples" and s_name != "smc" else 0
                diffs[part] = _rel_diff(np.concatenate([a[f"{model}.{s_name}.{part}"] for a in arrays], axis),
                                        one["arrays"][f"{s_name}.{part}"])
            worst[f"{model}.{s_name}"] = max(diffs.values())
            if set(r["diag"]) != set(want["diag"]) or max(diffs.values()) > CHAIN_TOL:
                problems.append(f"{model}.{s_name}: {diffs}")
            devices |= {f["calls"][s_name]["device"] for f in fleet}
            for f in fleet:
                got = {k: f["calls"][s_name]["launches"][k] for k in ("joseph_fwd", "joseph_adj")}
                if got != {k: one["calls"][s_name]["launches"][k] for k in got}:
                    problems.append(f"{model}.{s_name}: a rank's A/B launches {got}, one process's "
                                    f"{one['calls'][s_name]['launches']}")
    for line in logs[0].splitlines():
        if "draws/s" in line:
            log(f"[rest] 14d rank 0: {line.strip()}")
    rank_launches = [rk["foam"]["launches"] for rk in ranks]
    log(f"[rest] 14d cli bench-samplers --dist_backend gloo as two ranks on {sorted(devices)}: --model toy "
        f"{' '.join(FLEET[0][1])} against one process's --chains 8, --model foam {' '.join(FLEET[1][1])} "
        f"against 14c's; largest difference of each sampler's diagnostics, draws and final states, of "
        f"each array's largest magnitude, {worst} (tolerance {CHAIN_TOL:g}); foam launches per rank {rank_launches}, of its hmc call "
        f"{[rk['foam']['calls']['hmc']['launches'] for rk in ranks]}, one process's hmc call "
        f"{one_foam['calls']['hmc']['launches']}; fleet wall {wall:.1f} s on {smi}")
    if set(worst) != {"toy.hmc", "toy.nuts", "toy.smc", "foam.hmc"} or devices != {"cuda:0"} \
            or not all(x["joseph_fwd"] and x["joseph_adj"] for x in rank_launches):
        problems.append(f"samplers {sorted(worst)}, devices {devices}")
    if problems:
        raise AssertionError("14d: the two ranks are not one process: " + "; ".join(problems))
    summary["14d"] = dict(worst=worst, wall_s=wall, launches_per_rank=rank_launches[0])
    # A and B at one rank's share of the chains
    prob = bench_samplers.foam_problem(128, 20, 1e4, dev)
    n, n_det = 128, int(prob["meas"].shape[-1])
    table = torch.as_tensor(jr.angle_table_fused(prob["theta"], n, n, n_det), device=dev)
    rows = torch.as_tensor(jr.kernel_rows(table.cpu().numpy()), device=dev)
    post = bench_samplers.image_posterior(**prob, pnm=1e4, dev=dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    share = MCMC_CHAINS // 2
    x = softplus_forward(post.init(share, gen)).reshape(share, n, n).contiguous()
    g = torch.randn((share, table.shape[0], n_det), generator=gen, device=dev)
    rec_a = check_kernel("A chains rank", lambda v: jr.radon_fused(v, rows, n_det),
                         lambda v: jr.radon_fused_plain(v, table, n_det), x, table, n, n_det)
    rec_b = check_kernel("B chains rank", lambda v: jr.radon_fused_adjoint(v, rows, n),
                         lambda v: jr.radon_fused_adjoint_plain(v, table, n), g, table, n, n_det, adjoint=True)
    check_adjoint("A/B chains rank", lambda v: jr.radon_fused(v, rows, n_det),
                  lambda v: jr.radon_fused_adjoint(v, rows, n), x, g.abs())
    records["joseph_fwd"]["chains_rank"] = dict(rec_a, launches=rank_launches[0]["joseph_fwd"])
    records["joseph_adj"]["chains_rank"] = dict(rec_b, launches=rank_launches[0]["joseph_adj"])

    # -- 14e. cli sweep and --resume -----------------------------------------------
    with open(os.path.join(REPO, "configs", "hpo_foam.yaml")) as f:
        text = f.read()
    text = re.sub(r"(?m)^  input_path: .*$", f"  input_path: {os.path.join(REPO, 'dataset_foam')}", text)
    for key, value in SWEEP.items():
        text = re.sub(rf"(?m)^  {key}: .*$", f"  {key}: {value}", text)
    spec = os.path.join(tmp, "hpo_cut.yaml")
    with open(spec, "w") as f:
        f.write(text)
    root = os.path.join(tmp, "sweep")
    argv = ["sweep", "--config", spec, "--save-root", root, "--trials", str(SWEEP_TRIALS)]
    reset_counts()
    t0 = time.perf_counter()
    with Returns(train_mod, "run") as trials:
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(jr.LAUNCHES)
    with open(os.path.join(root, "sweep_results.json")) as f:
        results = json.load(f)
    log(f"[rest] 14e cli sweep (configs/hpo_foam.yaml, its space and surrogate mode, the base cut to {SWEEP}, "
        f"{SWEEP_TRIALS} trials): {len(trials)} trials in {wall:.1f} s, results {results}, launches {launches} "
        f"on {smi}")
    if rc != 0 or len(trials) != SWEEP_TRIALS or len(results) != SWEEP_TRIALS \
            or not all(np.isfinite(r["loss_final_mean"]) for r in results) \
            or not launches["joseph_fwd"] or not launches["joseph_adj"]:
        raise AssertionError(f"14e: sweep rc {rc}, {len(trials)} trials, results {results}")
    with Returns(train_mod, "run") as again:
        rc = cli.main(argv + ["--resume"])
    with open(os.path.join(root, "sweep_results.json")) as f:
        resumed = json.load(f)
    log(f"[rest] 14e --resume: {len(again)} trials run again, results the same: {resumed == results}")
    if rc != 0 or again or resumed != results:
        raise AssertionError("14e: --resume ran a recorded trial again or changed the results")
    summary["14e"] = dict(wall_s=wall, results=results, launches=launches)
    summary["seconds"] = time.perf_counter() - t_phase
    log(f"[rest] ok in {summary['seconds']:.1f} s")
    return summary


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
    sources = ("joseph_fwd", "joseph_adj", "joseph_fwd_static", "joseph_adj_static", "conv_fused",
               "conv_fused_mma")
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

        reset_counts()
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
        reset_counts()
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
        # the run as training left it, for phase 12 (the step check below
        # rewrites its caches for its 10 examples)
        shutil.copytree(train_run, os.path.join(tmp, "merit_run"), symlinks=True)
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
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(["train", "--config", toy_yaml, "--input_path", toy_data,
                       "--save_path", toy_run, "-i", str(TOY_STEPS)])
        wall = time.perf_counter() - t0
        toy_launches, gather_calls = dict(joseph_radon.LAUNCHES), radon.CALLS["radon"]
        if rc != 0:
            raise AssertionError(f"cli train (toy) returned {rc}")
        shutil.copytree(toy_run, os.path.join(tmp, "toy_eval_run"), symlinks=True)  # for phase 12
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
        reset_counts()
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
        odd_e = {  # (B, H, W, C, F, offset in floats)
            "E ragged, C 11, F 70": (3, 37, 35, 11, 70, 0),
            "E batch 1, 5 x 5, C 11, F 70": (1, 5, 5, 11, 70, 0),
            "E batch 1, 5 x 5": (1, 5, 5, 40, 40, 0),
            "E view off 16 bytes": (2, 16, 16, 40, 40, 1),
            "E C 80": (2, 20, 19, 80, 12, 0),
        }
        for name, (ob, oh, ow, oc, of, offset) in odd_e.items():
            x, kern, bias = probe_conv_fused.probe_inputs(ob, max(oh, ow), oc, of, 3, dev)
            check_conv_fused(name, at_offset(x[:, :oh, :ow], offset), kern, bias, timed=False)
        log("[probe] ok")

        # -- 9. the stretch recipe: make-data, train, A-D, FBP and gridrec -----
        phase_stretch(dev, smi, records, keep=tmp)

        # -- 10. the training options ------------------------------------------
        phase_options(dev, smi)

        # -- 11. exact-posterior MCMC on phases 5 and 6's runs ----------------
        log(f"[mcmc] summary {json.dumps(phase_mcmc(dev, smi, records, train_run, data, toy_run, truth))}")

        # -- 12. the evaluation stage on phases 5, 6 and 9's runs -------------
        log(f"[eval] summary {json.dumps(phase_eval(dev, smi, records, tmp, data))}")

    # -- 13. sharded training: NCCL at world size 1, two gloo ranks on one card
    log(f"[sharded] summary {json.dumps(phase_sharded(dev, smi, records))}")

    # -- 14. the rest of the CLI: check, compare-projectors, bench-samplers,
    # chains over two ranks, sweep
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rest_") as tmp:
        log(f"[rest] summary {json.dumps(phase_rest(dev, smi, records, tmp))}")
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    meta = {  # A and B run on C's and D's kernels
        "joseph_fwd": ("csrc/joseph_fwd_static.cu", "ct_pvae_tpu/ops/pallas_radon.py:455"),
        "joseph_adj": ("csrc/joseph_adj_static.cu", "ct_pvae_tpu/ops/pallas_radon.py:487"),
        "joseph_fwd_static": ("csrc/joseph_fwd_static.cu", "ct_pvae_tpu/ops/pallas_radon.py:124"),
        "joseph_adj_static": ("csrc/joseph_adj_static.cu", "ct_pvae_tpu/ops/pallas_radon.py:152"),
        "conv_fused_maxout": ("csrc/conv_fused_mma.cu", "scripts/probe_conv_fused.py:97"),
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
