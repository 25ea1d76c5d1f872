"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It measures the PyTorch and CUDA port
(``ct_pvae_tpu_torch``) on one NVIDIA GPU: set-up (counted from the start of
this process: imports, the seeded inputs and weights, the program's set-up,
the checked first steps and the warm-up), a window of ``--seconds``, then
the check of what the window's path produced against the plain reference
(``gpubench/reference``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``, and a ``breakdown``)
and last ``checks``, each compared number with its limit, which also close
standard error.

It exits 2 without a CUDA device, 3 if JAX or the JAX package was loaded,
and 1 on any other failure, printing no result in each case.  The program's
kernel builds stay inside the checkout (``ct_pvae_tpu_torch/build``), and
any PyTorch or Triton cache goes to ``.gpubench_cache`` there.
"""

import time

T0 = time.perf_counter()  # set-up starts with the process

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "ct_pvae_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # import the benchmark as the package ``gpubench`` from the checkout's root,
    # never its modules by their bare names from the script's folder
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != here and p != ROOT]
    cache = os.path.join(ROOT, ".gpubench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))

    import torch

    from gpubench import harness

    bench = harness.load_bench(ROOT)
    cell = harness.find_cell(bench, args.workload, ROOT)[0]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"gpubench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T0)
    found = forbidden_modules()
    if found:
        print(f"gpubench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
