"""Command line of the port (counterpart of ``ct_pvae_tpu/cli.py``).

  python -m ct_pvae_tpu_torch.cli train --input_path DS --save_path RUN --train ...
  python -m ct_pvae_tpu_torch.cli infer --run_path RUN --output OUT --cheap_init

``train`` (cli.py:27-212) and ``infer`` (cli.py:252-298) take the JAX
package's flags and dests, plus ``--device``; they run on the GPU unless
``--device cpu`` is given.  ``--config`` takes a JSON file (a run's
``config.json``).
"""

from __future__ import annotations

import argparse
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
    a("--reuse_cache", action="store_true", dest="reuse_cache")
    a("--metrics_every", type=int, dest="metrics_every", default=50)
    a("--spc", type=int, dest="steps_per_call", default=8,
      help="JAX scan fusion; the port runs one step per call whatever the value")
    a("--compute_dtype", dest="compute_dtype", default="float32")
    a("--conv_precision", dest="conv_precision", default=None,
      choices=["default", "high", "highest"])
    a("--conv_layout", dest="conv_layout", default="NHWC", choices=["NHWC", "NCHW"])
    a("--conv_impl", dest="conv_impl", default="direct", choices=["direct", "subpixel"])
    a("--config", dest="config_file", default=None, help="JSON config file (a run's config.json)")
    a("--device", dest="device", default="cuda", help="torch device (default: cuda)")


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
    for flag in ("visualize", "pixel_dist"):
        if getattr(cfg, flag):
            raise NotImplementedError(f"--{flag} is not ported yet (ROADMAP Queue 1, eval)")
    from .vi.train import run

    loss_final_mean = run(cfg, device=device)
    print(f"Average loss final : {loss_final_mean}")
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


COMMANDS = {"train": cmd_train, "infer": cmd_infer}


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m ct_pvae_tpu_torch.cli {{{','.join(COMMANDS)}}} ...", file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
