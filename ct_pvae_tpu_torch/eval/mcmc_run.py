"""MCMC runs: the toy simplex posterior and the image (foam) posteriors
(port of ``ct_pvae_tpu/eval/mcmc_run.py``).

``run_toy_mcmc`` is the reference's bin/toy_mcmc_v2.py as a library call:
it reads the masks and measurements a VAE run wrote, runs HMC, NUTS or SMC
over the simplex posterior with many chains and writes
``posterior_prob_trace.npy`` and per-pixel histograms.

``run_foam_mcmc`` samples the full H x W posterior of one object of a run
(``mcmc/image_model.py``) in chunks of bounded length, with the chunk
schedule of the JAX package's ``run_foam_mcmc``: NUTS warm-up with a
curvature metric, a Welford window across chunks, a host-side install of
the pooled variance and a dual-averaging restart; HMC warm-up chunks;
warm-started SMC in chunks of stages. On one GPU the chains are the batch
axis of every call.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, exact_f32, resolve_device
from ..mcmc import (HMCConfig, NUTSConfig, SMCConfig, effective_sample_size, hmc_sample,
                    nuts_sample, smc_sample, split_rhat)
from ..mcmc.image_model import as_f32
from ..mcmc.toy_model import toy_joint, toy_posterior_sampler
from ..prob.bijectors import IteratedSigmoidCentered
from ..prob.distributions import EPS, toy_prior

_TINY = float(np.finfo(np.float32).tiny)


def _scalar_diag(diag: dict) -> dict:
    """The scalar entries of a sampler's diagnostics as floats (skips the
    array and tuple state: final_state, inv_mass, the Welford triple)."""
    out = {}
    for k, v in diag.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        try:
            a = np.asarray(v, dtype=np.float64)
        except (ValueError, TypeError):
            continue
        if a.size == 1:
            out[k] = float(a)
    return out


def run_toy_mcmc(
    save_path: str,
    number_of_steps: int = 200000,
    burnin: int = 50000,
    example_num: int = 0,
    poisson_noise_multiplier: float = 1e3,
    num_chains: int = 8,
    sampler: str = "hmc",
    theta=None,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    """Returns the simplex-space trace (steps, chains, 4) (mcmc_run.py:47-162)."""
    dev = resolve_device(device)
    exact_f32()
    if theta is None:
        theta = np.array([0.0, np.pi / 2], np.float32)  # ref toy_mcmc_v2.py:44
    all_masks = np.load(os.path.join(save_path, "all_masks.npy"))
    all_proj = np.load(os.path.join(save_path, "all_proj_samples.npy"))
    mask = all_masks[example_num]
    used = mask > EPS
    theta_used, mask_used, meas = (as_f32(a, dev) for a in (theta[used], mask[used], all_proj[example_num][used]))

    # the reference runs one chain of `number_of_steps` (toy_mcmc_v2.py:139-148);
    # the budget is split across the chains
    steps = max(number_of_steps // num_chains, 1)
    burn = max(burnin // num_chains, 1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    log_prob = toy_posterior_sampler(meas, theta_used, mask_used, poisson_noise_multiplier)
    init = torch.zeros((num_chains, 3), device=dev)  # the uniform simplex point (ref :91-97)

    t0 = time.time()
    if sampler == "hmc":
        cfg = HMCConfig(num_results=steps, num_burnin=burn, num_leapfrog=5, step_size=6.5e-2,
                        num_adaptation=400)
        samples, diag = hmc_sample(log_prob, init, gen, cfg)
    elif sampler == "nuts":
        cfg = NUTSConfig(num_results=steps, num_burnin=burn, step_size=6.5e-2)
        samples, diag = nuts_sample(log_prob, init, gen, cfg)
    elif sampler == "smc":
        prior = toy_prior().to(dev)
        bij = IteratedSigmoidCentered
        init_particles = bij.inverse(prior.sample(gen, (max(number_of_steps // 100, 512),)))

        def log_prior(x):
            return prior.log_prob(bij.forward(x)) + bij.forward_log_det_jacobian(x)

        joint = toy_joint(meas, theta_used, mask_used, poisson_noise_multiplier)

        def log_lik(x):
            o = bij.forward(x)
            return joint(o) - prior.log_prob(torch.clamp(o, min=_TINY))

        cfg = SMCConfig(num_particles=init_particles.shape[0])
        particles, diag = smc_sample(log_prior, log_lik, init_particles, gen, cfg)
        samples = particles[None]
    else:
        raise ValueError(f"unknown sampler {sampler!r}")

    trace = IteratedSigmoidCentered.forward(samples.reshape(-1, 3)).reshape(samples.shape[0], -1, 4)
    trace = trace.cpu().numpy()
    if sampler in ("hmc", "nuts") and trace.shape[0] >= 8:
        diag = dict(diag)
        diag["rhat_max"] = float(np.max(split_rhat(trace)))
        diag["ess_min"] = float(np.min(effective_sample_size(trace)))
    print(f"{sampler} done in {(time.time() - t0) / 60:.2f} min; diag={_scalar_diag(diag)}")
    np.save(os.path.join(save_path, "posterior_prob_trace.npy"), trace.reshape(-1, 4))

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return trace
    flat = trace.reshape(-1, 4)
    for pix in range(4):
        plt.figure(figsize=[12.5, 4])
        plt.title(f"MCMC result, pixel {pix}")
        plt.hist(flat[:, pix], bins=25, histtype="stepfilled", density=True)
        plt.savefig(os.path.join(save_path, f"pixel_mcmc_{pix}.png"))
        plt.close()
    return trace


def amplitude_corrected(init_recon: np.ndarray, meas: torch.Tensor, theta_used, mask_used: torch.Tensor
                        ) -> np.ndarray:
    """The classical init at image scale (mcmc_run.py:232-250): the stack
    stores it ~10x below, and the Poisson-ML amplitude of rates a*r is
    a* = sum(counts) / sum(r), from the measurements alone, clipped to
    [1e-3, 1e3] (1 when the prediction is empty)."""
    from ..ops.radon import radon

    pos_init = torch.clamp(as_f32(init_recon, meas.device), min=0.0)
    theta = as_f32(theta_used, meas.device)
    with torch.no_grad():
        pred = radon(pos_init[None], theta, pad=True, n_det=int(meas.shape[-1]))[0] * mask_used[:, None]
    denom = float(pred.sum())
    amp = float(meas.sum()) / denom if denom > 1e-8 else 1.0
    return pos_init.cpu().numpy() * float(np.clip(amp, 1e-3, 1e3))


def run_foam_mcmc(
    save_path: str,
    number_of_steps: int = 2000,
    burnin: int = 1000,
    example_num: int = 0,
    poisson_noise_multiplier: Optional[float] = None,
    num_chains: int = 8,
    sampler: str = "nuts",
    prior: str = "tv",
    prior_weight: float = 10.0,
    seed: int = 0,
    chunk: int = 64,
    max_depth: int = 7,
    input_path: Optional[str] = None,
    output_prefix: str = "mcmc",
    smc_beta0: float = 0.0,
    init_source: str = "classical",
    mass_install: bool = True,
    device: DeviceLike = "cuda",
) -> dict:
    """Image-scale posterior sampling of one object of a finished VAE run
    (mcmc_run.py:165-508).

    Reads the run's measurement realisation (all_masks, all_proj_samples),
    builds the true-Poisson image posterior on the gather projector (as the
    reference chooses, mcmc_run.py:253-265), starts the chains at the run's
    classical init (amplitude-corrected) or its VAE posterior mean, and runs
    NUTS or HMC in chunks with bounded-memory moments, or SMC.

    Writes ``<prefix>_posterior_mean.npy`` and ``_std.npy`` ((x, y) images),
    and for NUTS and HMC ``_rhat.npy``, ``_ess.npy`` and, when the retained
    trace is scored on a pixel subset, ``_diag_dims.npy``, under
    ``save_path``. Returns {"mean", "std", "diag", "seconds", "draws"} and,
    when the ground truth resolves from the dataset path, "psnr_mcmc" and
    "psnr_init".
    """
    from ..config import Config
    from ..data import io as data_io
    from ..mcmc.image_model import (estimate_curvature_diag, image_log_prior, init_chains_from_recon,
                                    make_image_log_prob, softplus_forward, softplus_log_det_jacobian)
    from .metrics import compare

    if number_of_steps < 1:
        raise ValueError(f"number_of_steps must be >= 1, got {number_of_steps}")
    dev = resolve_device(device)
    exact_f32()
    cfg = Config.load(os.path.join(save_path, "config.json"))
    if input_path is None:
        input_path = cfg.input_path
    if poisson_noise_multiplier is None:
        poisson_noise_multiplier = cfg.poisson_noise_multiplier
    _, theta, _ = data_io.load_dataset(input_path)

    all_masks = np.load(os.path.join(save_path, "all_masks.npy"))
    all_proj = np.load(os.path.join(save_path, "all_proj_samples.npy"))
    mask = all_masks[example_num]
    used = mask > EPS
    theta_used = np.asarray(theta)[used]
    mask_used, meas = as_f32(mask[used], dev), as_f32(all_proj[example_num][used], dev)
    if init_source == "vae":
        init_recon = np.squeeze(
            np.load(os.path.join(save_path, "reconstruction_mean.npy"))[example_num]).astype(np.float32)
    else:
        init_stack = np.load(os.path.join(save_path, "all_input_encode.npy"))
        init_recon = amplitude_corrected(init_stack[example_num, :, :, 0], meas, theta_used, mask_used)
    x_size, y_size = init_recon.shape

    # the gather projector, as the reference: its reason (the TPU's bf16 MXU)
    # does not hold for the port's exact-f32 Joseph kernels, which chip_smoke.py
    # measures beside it instead of making them the default
    log_prob = make_image_log_prob(meas, theta_used, mask_used, poisson_noise_multiplier, x_size, y_size,
                                   prior=prior, prior_weight=prior_weight, use_pallas=False, device=dev)

    gen = torch.Generator(device=dev).manual_seed(seed)
    init = init_chains_from_recon(init_recon, num_chains, gen, device=dev)

    t0 = time.time()
    dim = x_size * y_size
    diag, inv_mass = {}, None
    if sampler == "smc":
        def log_prior_fn(x):
            o = softplus_forward(x).reshape(-1, x_size, y_size)
            return image_log_prior(o, prior, prior_weight) + softplus_log_det_jacobian(x)

        def log_lik_fn(x):
            return log_prob(x) - log_prior_fn(x)

        total_stages = max(number_of_steps // SMCConfig().mutation_steps, 8)
        stage_chunk = max(4, chunk // 8)
        scfg = SMCConfig(num_particles=num_chains, num_stages=stage_chunk, step_size=1e-2)
        particles = init
        # smc_beta0 > 0 warm-starts the tempering ladder from a good init cloud
        beta, ss, lev = smc_beta0, scfg.step_size, 0.0
        done = 0
        while done < total_stages:
            particles, diag = smc_sample(log_prior_fn, log_lik_fn, particles, gen, scfg,
                                         beta0=beta, step_size0=ss, log_evidence0=lev)
            beta, ss, lev = diag["beta"], diag["final_step_size"], diag["log_evidence"]
            done += stage_chunk
        o = softplus_forward(particles).reshape(num_chains, x_size, y_size)
        mean = o.mean(0)
        std = o.std(0, correction=0)  # jnp.std: ddof 0
        draws = num_chains
    else:
        if sampler == "nuts":
            # the physics-informed metric at the init point, refined by Welford
            # across warm-up chunks and installed at 80% of the burn-in
            curv = estimate_curvature_diag(init.mean(0), meas, theta_used, mask_used,
                                           poisson_noise_multiplier, x_size, y_size, prior=prior,
                                           prior_weight=prior_weight, gen=gen, use_pallas=False)
            inv_mass = 1.0 / curv
            warm_cfg = NUTSConfig(num_results=0, num_burnin=chunk, step_size=1e-2, max_depth=max_depth,
                                  adapt_mass=False)
            accum_cfg = NUTSConfig(num_results=0, num_burnin=chunk, step_size=1e-2, max_depth=max_depth,
                                   adapt_mass=True, welford_window=(0.0, 1.0), install_mass=False)
            cont_cfg = NUTSConfig(num_results=chunk, num_burnin=0, step_size=1e-2, max_depth=max_depth,
                                  adapt_step_size=False, adapt_mass=False)
            state, step_size, da = init, None, None
            welford = (torch.zeros((), device=dev), torch.zeros(dim, device=dev), torch.zeros(dim, device=dev))
            n_chunks = (burnin + chunk - 1) // chunk  # 0: no warm-up (e.g. init_source="vae")
            accum_from = int(0.3 * n_chunks)
            install_at = (max(int(0.8 * n_chunks), accum_from + 1)
                          if (n_chunks >= 3 and mass_install) else None)
            for ci in range(n_chunks):
                accumulating = ci >= accum_from and (install_at is None or ci < install_at)
                if accumulating:
                    _, d = nuts_sample(log_prob, state, gen, accum_cfg, inv_mass0=inv_mass,
                                       step_size0=step_size, welford0=welford, da0=da)
                    welford = d["welford"]
                else:
                    _, d = nuts_sample(log_prob, state, gen, warm_cfg, inv_mass0=inv_mass,
                                       step_size0=step_size, da0=da)
                state, step_size, da = d["final_state"], d["final_step_size"], d["da"]
                if install_at is not None and ci + 1 == install_at:
                    # host-side install: the pooled chain variance shrunk toward the
                    # curvature metric (Stan's regularised window estimate)
                    n = float(welford[0])
                    if n >= 8:
                        var = welford[2].cpu().numpy() / max(n - 1.0, 1.0)
                        shrink = n / (n + 5.0)
                        inv_mass = torch.as_tensor(
                            np.maximum(shrink * var + (1.0 - shrink) * inv_mass.cpu().numpy(), 1e-12),
                            dtype=torch.float32, device=dev)
                        da = None  # a new metric: restart the step-size adaptation

            def draw_chunk(st, ss):
                return nuts_sample(log_prob, st, gen, cont_cfg, inv_mass0=inv_mass, step_size0=ss)

        elif sampler == "hmc":  # identity metric; kept for comparisons with NUTS
            warm_hcfg = HMCConfig(num_results=1, num_burnin=chunk - 1, num_leapfrog=5, step_size=1e-3,
                                  num_adaptation=chunk)
            cont_hcfg = HMCConfig(num_results=chunk, num_burnin=0, num_leapfrog=5, step_size=1e-3,
                                  num_adaptation=0)
            state, step_size = init, None
            burned = 0
            while burned < burnin:
                _, d = hmc_sample(log_prob, state, gen, warm_hcfg, step_size0=step_size)
                state, step_size = d["final_state"], d["final_step_size_per_chain"]
                burned += chunk

            def draw_chunk(st, ss):
                return hmc_sample(log_prob, st, gen, cont_hcfg, step_size0=ss)
        else:
            raise ValueError(f"unknown sampler {sampler!r}")

        s1 = torch.zeros(dim, device=dev)
        s2 = torch.zeros(dim, device=dev)
        cnt = 0
        remaining = number_of_steps
        # the retained draws for the diagnostics; past 1.5 GB on the host a
        # fixed random pixel subset is scored instead (<prefix>_diag_dims.npy)
        kept, keep_dims = [], None
        if number_of_steps * num_chains * dim * 4 > 1.5e9:
            n_keep = min(dim, max(int(1.5e9 // (number_of_steps * num_chains * 4)), 1024))
            keep_dims = np.sort(np.random.default_rng(0).choice(dim, size=n_keep, replace=False))
            keep_idx = torch.as_tensor(keep_dims, device=dev)
        while remaining > 0:
            samples, diag = draw_chunk(state, step_size)
            take = min(remaining, samples.shape[0])
            o = softplus_forward(samples[:take])
            cnt += take * o.shape[1]
            s1 = s1 + o.sum((0, 1))
            s2 = s2 + (o * o).sum((0, 1))
            kept.append((o if keep_dims is None else o.index_select(2, keep_idx)).cpu().numpy())
            state = diag["final_state"]
            remaining -= take
        mean = (s1 / cnt).reshape(x_size, y_size)
        std = torch.sqrt(torch.clamp(s2 / cnt - (s1 / cnt) ** 2, min=0.0)).reshape(x_size, y_size)
        draws = cnt

        trace = np.concatenate(kept, axis=0)  # (T, C, D or n_keep)
        rhat = split_rhat(trace)
        ess = effective_sample_size(trace)
        diag = dict(diag)
        diag["rhat_max"] = float(np.max(rhat))
        diag["rhat_med"] = float(np.median(rhat))
        diag["ess_min"] = float(np.min(ess))
        diag["ess_med"] = float(np.median(ess))
        np.save(os.path.join(save_path, f"{output_prefix}_rhat.npy"), rhat)
        np.save(os.path.join(save_path, f"{output_prefix}_ess.npy"), ess)
        if keep_dims is not None:
            np.save(os.path.join(save_path, f"{output_prefix}_diag_dims.npy"), keep_dims)
        if inv_mass is not None:
            im = inv_mass.cpu().numpy()
            diag["inv_mass_spread"] = float(np.log10(np.max(im) / np.min(im)))
    mean = mean.cpu().numpy()
    std = std.cpu().numpy()
    dt = time.time() - t0
    dstr = _scalar_diag(diag)
    print(f"foam {sampler} ({x_size}x{y_size}, {num_chains} chains): {draws} draws in {dt:.1f} s "
          f"({draws / dt:.2f} draws/s); diag={dstr}")

    np.save(os.path.join(save_path, f"{output_prefix}_posterior_mean.npy"), mean)
    np.save(os.path.join(save_path, f"{output_prefix}_posterior_std.npy"), std)

    out = {"mean": mean, "std": std, "diag": dstr, "seconds": dt, "draws": int(draws)}
    try:
        gt = np.asarray(data_io.load_ground_truth(input_path)[example_num], np.float32)
    except (FileNotFoundError, OSError):
        return out
    if gt.shape == mean.shape:
        out["psnr_mcmc"] = compare(gt, np.clip(mean, 0.0, 1.0))[2]
        out["psnr_init"] = compare(gt, np.clip(init_recon, 0.0, 1.0))[2]
        print(f"posterior-mean PSNR {out['psnr_mcmc']:.2f} dB vs classical-init {out['psnr_init']:.2f} dB")
    return out
