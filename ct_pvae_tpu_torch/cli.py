"""Command line of the port (counterpart of ``ct_pvae_tpu/cli.py``).

  python -m ct_pvae_tpu_torch.cli make-data --img-type foam -n 100 --save-path DS
  python -m ct_pvae_tpu_torch.cli train --input_path DS --save_path RUN --train ...
  python -m ct_pvae_tpu_torch.cli infer --run_path RUN --output OUT --cheap_init
  python -m ct_pvae_tpu_torch.cli mcmc --model foam --save_path RUN --chains 8
  python -m ct_pvae_tpu_torch.cli merit --input_path DS --save_path RUN --pnm 1e4
  python -m ct_pvae_tpu_torch.cli visualize --input_path DS --save_path RUN --en 0
  python -m ct_pvae_tpu_torch.cli boxplot --save_paths RUN1 RUN2 ...

``make-data`` (cli.py:144-180), ``train`` (cli.py:27-212), ``merit``
(cli.py:214-249), ``infer`` (cli.py:252-298), ``mcmc`` (cli.py:303-357),
``visualize`` (cli.py:357-362) and ``fidelity`` (cli.py:385-396) take the
JAX package's flags and dests, plus ``--device``; they run on the GPU
unless ``--device cpu`` is given.  ``visualize-dataset`` (cli.py:365-382)
and ``boxplot`` (cli.py:400-412) take the JAX package's flags and run on
the host only.  ``--config`` takes a run's ``config.json`` or a YAML recipe
such as ``configs/toy.yaml``.  Figures need matplotlib, which raises an
``ImportError`` naming it where it is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np

from .config import Config


def _add_train_args(p: argparse.ArgumentParser, suppress: bool = False) -> None:
    """The JAX package's train flags (cli.py:27-123), same dests and defaults,
    plus ``--device``.  With ``suppress=True`` every default is
    ``argparse.SUPPRESS``, so the namespace holds only the flags typed, which
    are the ones that override a ``--config`` file."""

    def a(*names, **kw):
        if suppress:
            kw["default"] = argparse.SUPPRESS
        p.add_argument(*names, **kw)

    a("--ae", type=float, dest="adam_epsilon", default=1e-7)
    a("-b", type=int, dest="batch_size", default=4)
    a("--ns", type=int, dest="num_samples", default=2)
    a("--det", action="store_true", dest="deterministic")
    a("--dp", type=float, dest="dropout_prob", default=0.0)
    a("--en", type=int, dest="example_num", default=0)
    a("-i", type=int, dest="num_iter", default=100)
    a("--ik", type=int, dest="intermediate_kernel", default=4)
    a("--il", type=int, dest="intermediate_layers", default=2)
    a("--input_path", dest="input_path")
    a("--klaf", type=float, dest="kl_anneal_factor", default=1.0)
    a("--klm", type=float, dest="kl_multiplier", default=1.0)
    a("--ks", type=int, dest="kernel_size", default=4)
    a("--lr", type=float, dest="learning_rate", default=1e-4)
    a("--nb", type=int, dest="num_blocks", default=3)
    a("--nfm", type=int, dest="num_feature_maps", default=20)
    a("--nfmm", type=float, dest="num_feature_maps_multiplier", default=1.1)
    a("--norm", type=float, dest="norm", default=100.0)
    a("--normal", action="store_true", dest="use_normal")
    a("--nsa", type=int, dest="num_sparse_angles", default=10)
    a("--api", type=int, dest="angles_per_iter", default=5)
    a("--pnm", type=float, dest="poisson_noise_multiplier", default=(2**16 - 1) * 0.41)
    a("--pnm_start", type=float, dest="pnm_start", default=None)
    a("--train_pnm", action="store_true", dest="train_pnm")
    a("-r", type=int, dest="restore_num", default=None)
    a("--random", action="store_true", dest="random_angles")
    a("--uniform", action="store_false", dest="random_angles", default=False,
      help="force uniform sparse-angle masks (overrides a config file's random_angles)")
    a("--restore", action="store_true", dest="restore")
    a("--resume_total", action="store_true", dest="resume_total",
      help="with --restore: num_iter counts TOTAL iterations incl. restored ones")
    a("--save_path", dest="save_path")
    a("--se", type=int, dest="stride_encode", default=2)
    a("--si", type=int, dest="save_interval", default=100000)
    a("--td", type=int, dest="truncate_dataset", default=100)
    a("--train", action="store_true", dest="train")
    a("--ulc", action="store_true", dest="use_latest_ckpt")
    a("--visualize", action="store_true", dest="visualize")
    a("--pixel_dist", action="store_true", dest="pixel_dist")
    a("--num_repeats", type=int, dest="pixel_dist_repeats", default=10000)
    a("--ns1", type=int, dest="pixel_dist_samples_1", default=100)
    a("--real", action="store_true", dest="real_data")
    a("--no_pad", action="store_true", dest="no_pad")
    a("--toy_masks", action="store_true", dest="toy_masks")
    a("--algorithms", nargs="+", default=["gridrec"])
    a("--no_final_eval", action="store_true", dest="no_final_eval")
    a("--seed", type=int, dest="seed", default=0)
    a("--mesh_data", type=int, dest="mesh_data", default=1)
    a("--mesh_angle", type=int, dest="mesh_angle", default=1)
    a("--stream_batches", action="store_true", dest="stream_batches")
    a("--multihost", action="store_true", dest="multihost")
    a("--norm_type", dest="norm_type", default=None, choices=["instance"])
    a("--roll", action="store_true", dest="roll_augment")
    a("--reuse_cache", action="store_true", dest="reuse_cache",
      help="reload all_masks / all_proj_samples / all_input_encode from --save_path. "
           "An all_input_encode.npy that the JAX package wrote on the CPU comes from its "
           "gather-pair sirt/tv route, about 30%% away from the TPU (Joseph) route the "
           "port follows")
    a("--metrics_every", type=int, dest="metrics_every", default=50)
    a("--spc", type=int, dest="steps_per_call", default=8,
      help="train steps per chunk: on the GPU each a replay of the captured CUDA graph "
           "of the step; 1 = the eager step")
    a("--compute_dtype", dest="compute_dtype", default="float32")
    a("--conv_precision", dest="conv_precision", default=None,
      choices=["default", "high", "highest"])
    a("--conv_layout", dest="conv_layout", default="NHWC", choices=["NHWC", "NCHW"])
    a("--conv_impl", dest="conv_impl", default="direct", choices=["direct", "subpixel", "im2col"])
    a("--config", dest="config_file", default=None, help="config file: a run's config.json or a YAML recipe (configs/*.yaml); "
                           "typed flags override it")
    a("--device", dest="device", default="cuda", help="torch device (default: cuda)")


def cmd_make_data(argv) -> int:
    """Make a foam or toy dataset (sinograms, parameters, ground truth)."""
    p = argparse.ArgumentParser(prog="make-data")
    p.add_argument("--img-type", choices=["foam", "toy"], default="foam")
    p.add_argument("-n", "--num-train", type=int, default=100)
    p.add_argument("--num-angles", type=int, default=180)
    p.add_argument("--n-pixel", type=int, default=128)
    p.add_argument("--save-path", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--h5-dir", default=None,
                   help="ingest real .h5 scans from this directory instead of synthesizing "
                   "images (host only; needs h5py)")
    p.add_argument("--slices", default="middle",
                   help="z slices per .h5 scan: 'middle', 'all', or an int count of evenly "
                   "spaced slices, each one training example")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.h5_dir is not None:
        from .data.real import preformat_h5

        save = args.save_path or "dataset_real"
        sinos, _ = preformat_h5(args.h5_dir, save, slices=args.slices)
        print(f"Shape of sinograms: {sinos.shape}")
        print(f"Saved under {save}/  (train with --real)")
        return 0
    from .data.sinogram import make_dataset

    save = args.save_path or (
        "dataset_foam" if args.img_type == "foam" else "dataset_toy_discrete2"
    )
    images, sinos, theta = make_dataset(
        args.img_type, args.num_train, save_path=save,
        num_angles=args.num_angles, n_pixel=args.n_pixel, seed=args.seed, device=args.device,
    )
    print(f"Shape of sinograms: {sinos.shape}")
    print(f"Shape of original training images: {images.shape}")
    print(f"Saved under {save}/")
    return 0


def _parse_train_cfg(argv, prog: str):
    """(Config, device): typed flags over the ``--config`` file over defaults
    (cli.py:126-149, 183-190)."""
    p = argparse.ArgumentParser(prog=prog)
    _add_train_args(p)
    d = vars(p.parse_args(argv))
    sp = argparse.ArgumentParser(prog=prog)
    _add_train_args(sp, suppress=True)
    explicit = vars(sp.parse_args(argv))
    device = d.pop("device")
    config_file = d.pop("config_file")
    if config_file:
        d = {**Config.load(config_file).to_dict(),
             **{k: v for k, v in explicit.items() if k not in ("config_file", "device")}}
    return Config.from_dict({k: v for k, v in d.items() if k in Config.__dataclass_fields__}), device


def cmd_train(argv) -> int:
    """Train a P-VAE (and run the final evaluation) on the GPU by default."""
    cfg, device = _parse_train_cfg(argv, "train")
    from .vi.train import run

    loss_final_mean = run(cfg, device=device)
    print(f"Average loss final : {loss_final_mean}")
    if cfg.visualize:
        from .eval.visualize import visualize_run

        visualize_run(cfg, device=device)
    if cfg.pixel_dist:
        from .eval.pixel_dist import pixel_dist_run

        pixel_dist_run(cfg, device=device)
    return 0


def cmd_merit(argv) -> int:
    """Dataset merit of a trained run: the classical reconstructions of the
    noisy full and partial sinograms and the P-VAE's, against the truth."""
    p = argparse.ArgumentParser(prog="merit", description=cmd_merit.__doc__)
    p.add_argument("--input_path", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--pnm", type=float, dest="poisson_noise_multiplier", required=True)
    p.add_argument("--baseline_alg", choices=["fbp", "gridrec", "gridrec_fourier"], default="fbp",
                   help="classical recon of the full/partial rows: ramp FBP, or Fourier "
                   "regridding ('gridrec_fourier' is its alias), saved to "
                   "final_ave_merit_gridrec.npy")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    from .data import io as data_io
    from .eval.merit import final_merit

    baseline = "gridrec" if args.baseline_alg == "gridrec_fourier" else args.baseline_alg
    sinos, theta, _ = data_io.load_dataset(args.input_path)
    gt = data_io.load_ground_truth(args.input_path)
    run = lambda name: os.path.join(args.save_path, name)
    mean_path = run("reconstruction_mean.npy")
    rec_mean = np.load(mean_path) if os.path.exists(mean_path) else None
    final_merit(
        gt, sinos, np.load(run("all_masks.npy")), np.load(run("all_proj_samples.npy")),
        np.load(run("reconstruction_final.npy")), theta, args.poisson_noise_multiplier,
        save_path=args.save_path, reconstruction_mean=rec_mean, baseline_alg=baseline,
        device=args.device,
    )
    return 0


def cmd_infer(argv) -> int:
    """Amortized inference: reconstruct NEW sinograms with a trained run and
    write posterior mean / std / sample maps."""
    p = argparse.ArgumentParser(prog="infer", description=cmd_infer.__doc__)
    p.add_argument("--run_path", required=True,
                   help="trained run dir (config.json + training_checkpoints/)")
    p.add_argument("--input_path", default=None,
                   help="dataset dir of NEW sinograms (default: the run's)")
    p.add_argument("--output", required=True, dest="output_path",
                   help="output dir for reconstruction artifacts")
    p.add_argument("--passes", type=int, default=8,
                   help="independent latent draws for the uncertainty map")
    p.add_argument("-r", type=int, dest="ckpt_num", default=None,
                   help="checkpoint number (default: latest)")
    p.add_argument("--real", action="store_true",
                   help="measured data: skip synthetic masking noise")
    p.add_argument("--pnm", type=float, default=None,
                   help="override the measurement dose (Poisson multiplier)")
    p.add_argument("--cheap_init", action="store_true",
                   help="substitute sirt/tv init channels with the one-shot "
                        "ramp-FBP (same channel layout; serving-latency mode)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    from .vi.infer import amortized_infer

    overrides = {}
    if args.real:
        overrides["real_data"] = True
    if args.pnm is not None:
        overrides["poisson_noise_multiplier"] = args.pnm
        overrides["pnm_start"] = None
    if args.cheap_init:
        overrides["cheap_init"] = True
    out = amortized_infer(
        args.run_path,
        args.output_path,
        input_path=args.input_path,
        num_passes=args.passes,
        ckpt_num=args.ckpt_num,
        overrides=overrides,
        seed=args.seed,
        device=args.device,
    )
    print(f"reconstructed {out['mean'].shape[0]} examples -> {args.output_path}")
    print(f"mean ELBO loss: {float(np.mean(out['loss'])):.6g}")
    t = out["timing"]
    print(f"setup {t['setup_s']:.3f} s, {len(t['batch_s'])} batches in {sum(t['batch_s']):.3f} s")
    return 0


def cmd_mcmc(argv) -> int:
    """Exact-posterior MCMC over one object of a VAE run: the toy 2x2 simplex
    posterior or the full image posterior."""
    p = argparse.ArgumentParser(prog="mcmc", description=cmd_mcmc.__doc__)
    p.add_argument("--save_path", required=True, help="path of the VAE run (masks live there)")
    p.add_argument("--model", choices=["toy", "foam"], default="toy",
                   help="toy: 2x2 simplex posterior (reference bin/toy_mcmc_v2.py); "
                   "foam: full image-space posterior")
    p.add_argument("-s", type=int, dest="number_of_steps", default=None,
                   help="post-burnin draws (default: 200000 toy, 2000 foam)")
    p.add_argument("-b", type=int, dest="burnin", default=None,
                   help="burn-in steps (default: 50000 toy, 1000 foam)")
    p.add_argument("--en", type=int, dest="example_num", default=0)
    p.add_argument("--pnm", type=float, default=None,
                   help="default: 1e3 toy; the run config's pnm for foam")
    p.add_argument("--chains", type=int, default=8)
    p.add_argument("--sampler", choices=["hmc", "nuts", "smc"], default=None,
                   help="default: hmc toy (reference kernel), nuts foam")
    p.add_argument("--prior", choices=["tv", "smooth", "flat"], default="tv",
                   help="foam pixel-space prior (mcmc/image_model.py)")
    p.add_argument("--prior_weight", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    from .eval.mcmc_run import run_foam_mcmc, run_toy_mcmc

    if args.model == "foam":
        run_foam_mcmc(
            save_path=args.save_path,
            number_of_steps=args.number_of_steps if args.number_of_steps is not None else 2000,
            burnin=args.burnin if args.burnin is not None else 1000,
            example_num=args.example_num,
            poisson_noise_multiplier=args.pnm,
            num_chains=args.chains,
            sampler=args.sampler or "nuts",
            prior=args.prior,
            prior_weight=args.prior_weight,
            seed=args.seed,
            device=args.device,
        )
        return 0
    run_toy_mcmc(
        save_path=args.save_path,
        number_of_steps=args.number_of_steps if args.number_of_steps is not None else 200000,
        burnin=args.burnin if args.burnin is not None else 50000,
        example_num=args.example_num,
        poisson_noise_multiplier=args.pnm if args.pnm is not None else 1e3,
        num_chains=args.chains,
        sampler=args.sampler or "hmc",
        seed=args.seed,
        device=args.device,
    )
    return 0


def cmd_visualize(argv) -> int:
    """Panels and metrics of one example of a trained run (the train flags)."""
    cfg, device = _parse_train_cfg(argv, "visualize")
    from .eval.visualize import visualize_run

    visualize_run(cfg, device=device)
    return 0


def cmd_visualize_dataset(argv) -> int:
    """Full vs partial-random vs partial-uniform sinogram and the padded
    ground truth of one example (reference bin/visualize_dataset.py)."""
    p = argparse.ArgumentParser(prog="visualize-dataset", description=cmd_visualize_dataset.__doc__)
    p.add_argument("--en", type=int, dest="example_num", default=0)
    p.add_argument("--input_path", default="dataset_foam")
    p.add_argument("--save_path_random", default=None)
    p.add_argument("--save_path_uniform", default=None)
    p.add_argument("--nsa", type=int, dest="num_sparse_angles", default=20,
                   help="undoes the 1/nsa dose normalization on partials")
    p.add_argument("--out", dest="out_dir", default=None)
    args = p.parse_args(argv)
    from .eval.dataset_viz import visualize_dataset

    for name, path in visualize_dataset(**vars(args)).items():
        print(name, path)
    return 0


def cmd_fidelity(argv) -> int:
    """Foam packer porosity curve and full-sinogram FBP metric distributions."""
    p = argparse.ArgumentParser(prog="fidelity", description=cmd_fidelity.__doc__)
    p.add_argument("-n", type=int, dest="num", default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", dest="out_dir", default="fidelity_out")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    from .eval.fidelity import fidelity_report

    print(json.dumps(fidelity_report(args.out_dir, num=args.num, seed=args.seed, device=args.device),
                     indent=1))
    return 0


def cmd_boxplot(argv) -> int:
    """Box plots of final_ave_merit over trials (5 conditions with
    ``<run>_uniform`` siblings, else 3)."""
    p = argparse.ArgumentParser(prog="boxplot", description=cmd_boxplot.__doc__)
    p.add_argument("--save_paths", nargs="+", required=True, help="random-mask run dirs (trials)")
    p.add_argument("--uniform_paths", nargs="+", default=None,
                   help="paired uniform-mask run dirs; defaults to <save_path>_uniform siblings "
                   "when they all exist")
    p.add_argument("--out", default=".")
    args = p.parse_args(argv)
    from .eval.boxplot import make_box_plots

    make_box_plots(args.save_paths, args.out, uniform_paths=args.uniform_paths)
    return 0


COMMANDS = {
    "make-data": cmd_make_data,
    "train": cmd_train,
    "infer": cmd_infer,
    "mcmc": cmd_mcmc,
    "merit": cmd_merit,
    "visualize": cmd_visualize,
    "visualize-dataset": cmd_visualize_dataset,
    "fidelity": cmd_fidelity,
    "boxplot": cmd_boxplot,
}


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m ct_pvae_tpu_torch.cli {{{','.join(COMMANDS)}}} ...", file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
