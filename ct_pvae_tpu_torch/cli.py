"""Command line of the port (counterpart of ``ct_pvae_tpu/cli.py``).

  python -m ct_pvae_tpu_torch.cli infer --run_path RUN --output OUT --cheap_init

Slice 1 carries the ``infer`` subcommand (cli.py:252-298), with the same
flags plus ``--device``.  It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np


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


COMMANDS = {"infer": cmd_infer}


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m ct_pvae_tpu_torch.cli {{{','.join(COMMANDS)}}} ...", file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
