"""Port's serving setup (masks, backprojector, FBP, cheap-init stack) against
the JAX package on the CPU."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ct_pvae_tpu.data import masks as jmasks
from ct_pvae_tpu.data.recon_init import classical_recon_stack as jax_stack
from ct_pvae_tpu.ops.radon import backproject as jax_backproject
from ct_pvae_tpu_torch.data import masks
from ct_pvae_tpu_torch.data.recon_init import classical_recon_stack
from ct_pvae_tpu_torch.ops import fbp
from ct_pvae_tpu_torch.ops.radon import backproject

jfbp = importlib.import_module("ct_pvae_tpu.ops.fbp")  # the package re-exports fbp()

CPU = torch.device("cpu")
B, A, P = 8, 24, 36


def _sino(seed=0):
    rng = np.random.default_rng(seed)
    theta = np.sort(rng.uniform(0, np.pi, A)).astype(np.float32)
    return rng.uniform(0, 1, (B, A, P)).astype(np.float32), theta


@pytest.mark.parametrize("random", [True, False])
def test_make_masks_bitwise(random):
    ours = masks.make_masks(37, 180, 20, random=random, seed=5)
    ref = jmasks.make_masks(37, 180, 20, random=random, seed=5)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


def test_real_data_measurements_equal(tmp_path):
    sino, _ = _sino()
    ours = masks.create_all_masks(sino, A, CPU, num_sparse_angles=5, random=True,
                                  real_data=True, truncate_dataset=B, seed=2)
    ref = jmasks.create_all_masks(sino, A, num_sparse_angles=5, random=True, real_data=True,
                                  train=True, truncate_dataset=B, seed=2)
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o, np.asarray(r))


def test_poisson_measurements_statistics():
    """torch.poisson and jax.random.poisson draw different numbers; the
    port's draws must still have the Poisson mean and variance of the rate."""
    pnm, nsa, val = 1e3, 4, 0.2
    sino = np.full((64, 16, 100), val, np.float32)
    m, proj = masks.create_all_masks(sino, 16, CPU, poisson_noise_multiplier=pnm,
                                     num_sparse_angles=nsa, random=True,
                                     truncate_dataset=64, seed=0)
    counts = (proj * pnm)[m > 0]                      # measured entries, in counts
    rate = val / nsa * pnm                            # 50 counts
    assert np.allclose(counts, np.round(counts), atol=1e-3)  # whole counts
    n = counts.size                                   # 25,600 draws
    # mean within 5 standard errors; variance within 5 of its standard errors
    assert abs(counts.mean() - rate) < 5 * np.sqrt(rate / n)
    assert abs(counts.var() - rate) < 5 * rate * np.sqrt(2.0 / n)
    assert np.all(proj[m == 0] == 0)


def test_backproject_matches_jax():
    sino, theta = _sino(1)
    ours = backproject(torch.from_numpy(sino), torch.from_numpy(theta), P, P).numpy()
    ref = np.asarray(jax_backproject(jnp.asarray(sino), jnp.asarray(theta), P, P))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("filter_name", ["ramp", "shepp-logan", "none"])
def test_fbp_matches_jax(filter_name):
    sino, theta = _sino(2)
    np.testing.assert_allclose(fbp.fourier_filter(P, filter_name), jfbp.fourier_filter(P, filter_name))
    ours = fbp.fbp(torch.from_numpy(sino), torch.from_numpy(theta), 25, 25, filter_name).numpy()
    ref = np.asarray(jfbp.fbp(jnp.asarray(sino), jnp.asarray(theta), 25, 25, filter_name))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_cheap_init_stack_matches_jax():
    """The foam paper algorithm list under cheap_init, same measurements."""
    sino, theta = _sino(3)
    m = masks.make_masks(B, A, 6, random=True, seed=1)
    proj = sino * m[:, :, None]
    algs = ["sirt", "tv", "fbp", "gridrec"]
    x = int(np.floor(P / np.sqrt(2) - 2))
    ours = classical_recon_stack(proj, m, theta, algs, x, x, CPU, cheap_init=True)
    ref = jax_stack(proj, m, theta, algs, x, x, save_path=None, cheap_init=True)
    assert ours.shape == ref.shape == (B, x, x, 5)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_iterative_init_without_cheap_init_is_not_ported():
    """sirt and tv are ported now (test_full_init_stack_matches_jax_tpu_route);
    the Fourier-regridding gridrec is the init algorithm still to port."""
    sino, theta = _sino(4)
    m = masks.make_masks(B, A, 6, seed=1)
    with pytest.raises(NotImplementedError, match="gridrec_fourier"):
        classical_recon_stack(sino, m, theta, ["gridrec_fourier", "fbp"], 20, 20, CPU)


def test_full_init_stack_matches_jax_tpu_route(monkeypatch):
    """The paper's stack (sirt 30, tv 60, fbp, gridrec, mask) against the JAX
    package's accelerator route, where sirt/tv run on radon_pallas /
    backproject_pallas (recon_init.py:144-153; here in interpret mode).  On
    the CPU the JAX package would take its XLA projector pair instead, another
    discretisation."""
    sino, theta = _sino(3)
    m = masks.make_masks(B, A, 6, random=True, seed=1)
    proj = sino * m[:, :, None]
    algs = ["sirt", "tv", "fbp", "gridrec"]
    x = int(np.floor(P / np.sqrt(2) - 2))
    ours = classical_recon_stack(proj, m, theta, algs, x, x, CPU)
    pr = importlib.import_module("ct_pvae_tpu.ops.pallas_radon")
    fwd, adj = pr.radon_pallas, pr.backproject_pallas
    monkeypatch.setattr(pr, "radon_pallas", lambda img, th, n: fwd(img, th, n, True))
    monkeypatch.setattr(pr, "backproject_pallas", lambda s, th, h, w: adj(s, th, h, w, True))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    ref = jax_stack(proj, m, theta, algs, x, x, save_path=None)
    assert ours.shape == ref.shape == (B, x, x, 5)
    # float32 through 30 / 60 iterations of the pair in two frameworks (4.6e-6
    # of the channel's largest value measured): 5e-5 of it, where the JAX
    # package's CPU (XLA) pair would be ~30% off
    for c, name in enumerate(algs + ["mask"]):
        np.testing.assert_allclose(ours[..., c], ref[..., c], rtol=0,
                                   atol=5e-5 * np.abs(ref[..., c]).max(), err_msg=name)


def test_reuse_cache_reloads_serving_artifacts(tmp_path):
    """With reuse_cache (the paper run's setting), a second serve into the
    same output dir reloads its masks, measurements and init stack, as the
    JAX package's create_all_masks / classical_recon_stack do."""
    sino, theta = _sino(5)
    m1, p1 = masks.create_all_masks(sino, A, CPU, save_path=str(tmp_path), random=True,
                                    num_sparse_angles=6, truncate_dataset=B, seed=1)
    m2, p2 = masks.create_all_masks(sino, A, CPU, save_path=str(tmp_path), random=True,
                                    num_sparse_angles=6, truncate_dataset=B, seed=2,
                                    reuse_cache=True)
    assert np.array_equal(m1, m2) and np.array_equal(p1, p2)  # seed 2 ignored: cache hit
    s1 = classical_recon_stack(p1, m1, theta, ["fbp"], 20, 20, CPU, save_path=str(tmp_path))
    np.save(tmp_path / "all_input_encode.npy", s1 + 1)  # mark the cache
    s2 = classical_recon_stack(p1, m1, theta, ["fbp"], 20, 20, CPU, save_path=str(tmp_path),
                               reuse_cache=True)
    np.testing.assert_array_equal(s2, s1 + 1)
