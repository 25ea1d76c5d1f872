"""The port's gather projector (``ops/radon.py`` ``radon``) and the projector
routing (``vi/serve.py`` ``joseph_route``) against the JAX package on the CPU:
``ct_pvae_tpu.ops.radon.radon``, its gradient, the rule of train.py:254-256
and one eval step on the gather route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_parity import jax_draws
from ct_pvae_tpu.config import Config as JaxConfig
from ct_pvae_tpu.ops.radon import radon as jax_radon
from ct_pvae_tpu.vi.train import Trainer as JaxTrainer
from ct_pvae_tpu_torch.config import Config
from ct_pvae_tpu_torch.ops import joseph_radon, radon
from ct_pvae_tpu_torch.utils.flax_msgpack import load_checkpoint
from ct_pvae_tpu_torch.vi.serve import Server, joseph_route

CPU = torch.device("cpu")

# (image shape, angles, pad, n_det): the toy 2x2, 16^2 and 24x24, padded or not
CASES = [
    ((4, 2, 2), 2, False, None),
    ((3, 16, 16), 5, False, None),
    ((3, 16, 16), 5, True, None),
    ((2, 24, 24), 7, False, None),
    ((2, 24, 24), 7, True, 40),
]


def _inputs(shape, a, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, shape).astype(np.float32)
    theta = np.sort(rng.uniform(0, np.pi, a)).astype(np.float32)
    return img, theta


@pytest.mark.parametrize("shape, a, pad, n_det", CASES)
def test_radon_matches_jax(shape, a, pad, n_det):
    img, theta = _inputs(shape, a)
    ref = np.asarray(jax_radon(jnp.asarray(img), jnp.asarray(theta), pad=pad, n_det=n_det))
    calls = radon.CALLS["radon"]
    out = radon.radon(torch.from_numpy(img), torch.from_numpy(theta), pad=pad, n_det=n_det).numpy()
    assert radon.CALLS["radon"] == calls + 1
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("shape, a, pad, n_det", [CASES[0], CASES[2], CASES[4]])
def test_radon_gradient_matches_jax_grad(shape, a, pad, n_det):
    """Autograd through the gathers (a scatter-add backward) against jax.grad
    of the same weighted sum."""
    img, theta = _inputs(shape, a, 1)
    ref_fwd = jax_radon(jnp.asarray(img), jnp.asarray(theta), pad=pad, n_det=n_det)
    wts = np.random.default_rng(2).normal(size=ref_fwd.shape).astype(np.float32)
    ref = np.asarray(jax.grad(lambda x: jnp.sum(
        jax_radon(x, jnp.asarray(theta), pad=pad, n_det=n_det) * wts))(jnp.asarray(img)))
    x = torch.from_numpy(img).requires_grad_()
    (radon.radon(x, torch.from_numpy(theta), pad=pad, n_det=n_det) * torch.from_numpy(wts)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _jax_rule(use_pallas, n_det, backend, mesh):
    """train.py:254-256, as the JAX Trainer evaluates it."""
    return use_pallas and n_det >= 64 and (backend == "tpu" or mesh is not None)


# (use_pallas, n_det, device, kernel_route); CUDA stands for the TPU, the
# kernel-route request for the JAX Trainer's mesh
ROUTES = [
    (False, 64, "cuda", False),
    (True, 2, "cuda", False),
    (True, 63, "cuda", False),
    (True, 64, "cuda", False),
    (True, 64, "cpu", False),
    (True, 64, "cpu", True),
    (False, 184, "cpu", True),
    (True, 2, "cpu", True),
]


@pytest.mark.parametrize("use_pallas, n_det, device, kernel_route", ROUTES)
def test_route_follows_the_jax_trainer(use_pallas, n_det, device, kernel_route):
    cfg = Config(use_pallas=use_pallas)
    want = _jax_rule(use_pallas, n_det, "tpu" if device == "cuda" else "cpu",
                     object() if kernel_route else None)
    assert joseph_route(cfg, n_det, torch.device(device), kernel_route) == want


def test_eval_step_on_the_gather_route_matches_jax(tmp_path):
    """``use_pallas: false`` at a 64-pixel detector: the JAX Trainer (on a
    one-device mesh) and the port's Server (asking for the kernel route) both
    take the gather projector, and one eval step's loss agrees; the Joseph
    route gives another loss."""
    n, a, p, batch = 4, 10, 64, 4
    rng = np.random.default_rng(3)
    theta = np.sort(rng.uniform(0, np.pi, a)).astype(np.float32)
    sinos = rng.uniform(0, 5, (n, a, p)).astype(np.float32)
    kw = dict(truncate_dataset=n, batch_size=batch, num_sparse_angles=4, random_angles=True,
              num_samples=2, poisson_noise_multiplier=1e4, pnm_start=1e3, num_iter=100,
              algorithms=["fbp", "gridrec"], num_blocks=2, num_feature_maps=4,
              intermediate_layers=1, kernel_size=4, intermediate_kernel=4, stride_encode=2,
              use_normal=True, train=True, use_pallas=False, seed=2)
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "angle"))
    tr = JaxTrainer(JaxConfig(save_path=str(tmp_path), **kw), sinograms=sinos, theta=theta,
                    mesh=mesh)
    tr.checkpoint()
    key = jax.random.PRNGKey(5)
    bidx = np.arange(batch, dtype=np.int32)
    _, loss_j, aux_j = tr._eval_step(tr.state, tr.data, jnp.asarray(bidx),
                                     jnp.arange(a, dtype=jnp.int32), key)

    losses = {}
    for use_pallas in (False, True):
        cfg = Config(save_path=str(tmp_path), reuse_cache=True, **{**kw, "use_pallas": use_pallas})
        srv = Server(cfg, sinos, theta, CPU, kernel_route=True)
        assert srv.joseph == use_pallas
        srv.load_state(load_checkpoint(str(tmp_path / "training_checkpoints" / "ckpt-0.msgpack")))
        shapes, out_shape = srv.draw_shapes(batch)
        calls, launches = radon.CALLS["radon"], dict(joseph_radon.LAUNCHES)
        loss, aux = srv.eval_step(torch.as_tensor(bidx), jax_draws(key, shapes, out_shape, 2))
        assert radon.CALLS["radon"] == calls + (not use_pallas)
        assert joseph_radon.LAUNCHES == launches  # the plain versions launch nothing
        losses[use_pallas] = loss.item()
        if not use_pallas:
            close = lambda t, j: np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4)
            close(loss, loss_j)
            close(aux.loglik, aux_j.loglik)
            close(aux.log_prob_M_given_R, aux_j.log_prob_M_given_R)
    assert abs(losses[True] - losses[False]) > 1e-3 * abs(losses[False])
