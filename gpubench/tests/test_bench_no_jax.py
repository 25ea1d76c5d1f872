"""A run loads neither JAX nor the JAX package, compared by whole top-level names."""

import os
import subprocess
import sys

from gpubench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCRIPT = r"""
import sys, time
sys.path.insert(0, {root!r})
import torch
import gpubench.run as run
from gpubench import harness, calibrate
import gpubench.drivers.train, gpubench.drivers.serve, gpubench.weights.seeded, gpubench.datasets.foams
import ct_pvae_tpu_torch.vi.serve as serve
route = serve.joseph_route
serve.joseph_route = lambda cfg, n_det, device, kernel_route=False, mesh=None, num_angles=None: \
    route(cfg, n_det, device, True, mesh, num_angles)
small = {small!r}
bench = harness.load_bench()
for cell in ("paper_train", "stretch_serve"):
    harness.run_cell(bench, cell, 5, 0.5, False, torch.device("cpu"), time.perf_counter(), small)
assert "ct_pvae_tpu_torch" in sys.modules
print(",".join(run.forbidden_modules()) or "none")
"""


def test_a_run_loads_no_jax(small):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=ROOT, small=small)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "none"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ct_pvae_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert run.forbidden_modules() == [m for m in ("jax", "jaxlib", "flax", "ct_pvae_tpu")
                                       if m in {k.split(".")[0] for k in sys.modules}]
    monkeypatch.setitem(sys.modules, "ct_pvae_tpu.vi", sys)
    assert "ct_pvae_tpu" in run.forbidden_modules()
