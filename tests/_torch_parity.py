"""Shared helpers of the PyTorch-port parity tests (``tests/test_torch_*.py``).

The JAX package is the reference; both sides get the same numpy inputs.  The
JAX package's random draws are replayed into the port as tensors: ``jax_draws``
walks the key tree of ``ct_pvae_tpu/vi/loss.py:elbo_loss``.

Importing this module limits torch to one CPU thread.  The suite runs in
several worker processes at once; torch's default of one thread per core in
each of them starved the others (tests/test_multihost.py's two-process gloo
start-up timed out at 30 s when the port's tests ran beside it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ct_pvae_tpu_torch.prob.distributions import EPS
from ct_pvae_tpu_torch.vi.loss import Draws

torch.set_num_threads(1)


def jax_draws(key, latent_shapes, out_shape, num_samples) -> Draws:
    """The latent normals and output uniforms elbo_loss draws from ``key``."""
    key, _dropout_key = jax.random.split(key)
    eps, u = [], []
    for key_s in jax.random.split(key, num_samples):
        keys = jax.random.split(key_s, len(latent_shapes) + 2)
        eps.append([
            torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))
            for k, shape in zip(keys, latent_shapes)
        ])
        key_out = jax.random.fold_in(key_s, 7)
        uni = jax.random.uniform(key_out, out_shape, jnp.float32, minval=EPS, maxval=1.0 - EPS)
        u.append(torch.from_numpy(np.array(uni)))
    return Draws(eps, u)


class JaxReplaySampler:
    """Port sampler that hands ``amortized_infer`` the draws the JAX package's
    ``amortized_infer`` makes (vi/infer.py: key PRNGKey(seed+7), one split per
    batch, one key per pass)."""

    def __init__(self, seed: int, num_batches: int, num_passes: int):
        key = jax.random.PRNGKey(seed + 7)
        self.keys = {}
        for bi in range(num_batches):
            key, bkey = jax.random.split(key)
            for p, k in enumerate(jax.random.split(bkey, num_passes)):
                self.keys[(bi, p)] = k

    def __call__(self, batch_index, pass_index, latent_shapes, out_shape, num_samples):
        return jax_draws(self.keys[(batch_index, pass_index)], latent_shapes, out_shape, num_samples)


class JaxTrainSampler:
    """Port trainer sampler that replays the JAX Trainer's draws
    (vi/train.py): step s uses fold_in(loop_key, s), loop_key being the third
    split of PRNGKey(seed); eval batch i of final_evaluation uses the i-th
    split of PRNGKey(seed + 3)."""

    def __init__(self, seed: int):
        self.loop_key = jax.random.split(jax.random.PRNGKey(seed), 3)[2]
        self.eval_seed = seed + 3

    def __call__(self, kind, index, latent_shapes, out_shape, num_samples):
        if kind == "train":
            key = jax.random.fold_in(self.loop_key, index)
        else:
            k = jax.random.PRNGKey(self.eval_seed)
            for _ in range(index + 1):
                k, key = jax.random.split(k)
        return jax_draws(key, latent_shapes, out_shape, num_samples)


_split2 = jax.jit(jax.vmap(jax.random.split))
_split4 = jax.jit(jax.vmap(lambda k: jax.random.split(k, 4)))
_uniform = jax.jit(jax.vmap(jax.random.uniform))


def _normals(keys, dim):
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (dim,)))(keys))


class JaxSamplerKeys:
    """Draw source of the port's samplers that walks the key tree of the JAX
    sampler started from ``key`` (one key a chain, split where the JAX
    sampler splits it: ``mcmc/hmc.py:86-96``, ``mcmc/nuts.py:166-167,
    253-255, 281-282, 304``, ``mcmc/smc.py:42, 80-96, 146, 156``), so a port
    transition makes the JAX transition's draws.  A masked-out chain's keys
    stay as they are, as a finished chain's do under ``vmap``.

    ``margins`` collects, for every decision of an active chain, its distance
    from the threshold: |log u - log ratio| for accept and take decisions,
    |u - 1/2| for NUTS's direction; ``last_active`` is the mask of the latest
    decision (the U-turn checks that follow it run on the same chains)."""

    def __init__(self, key, mutation_steps: int = 0):
        self.key = key
        self.mutation_steps = mutation_steps
        self.margins = []
        self.last_active = None

    def _chain_keys(self, n):
        self.key, sub = jax.random.split(self.key)
        return np.asarray(_split2(jax.random.split(sub, n)))  # (n, 2, key)

    def normal(self, tag, shape, device):
        n, dim = shape
        if tag in ("hmc.momentum", "nuts.momentum"):
            k = self._chain_keys(n)
            self.next_key = k[:, 1]        # hmc: the accept key; nuts: the loop key
            return torch.from_numpy(_normals(k[:, 0], dim).copy())
        if tag == "smc.momentum":
            if self.mut_keys is None:  # split(k_mut, N), then split(., mutation_steps) a particle
                self.mut_keys = np.asarray(jax.vmap(lambda k: jax.random.split(k, self.mutation_steps))(
                    jax.random.split(self._k_mut, n)))
                self.step = 0
            k = np.asarray(_split2(self.mut_keys[:, self.step]))
            self.step += 1
            self.next_key = k[:, 1]
            return torch.from_numpy(_normals(k[:, 0], dim).copy())
        raise KeyError(tag)

    def uniform(self, tag, shape, device):
        if tag != "smc.resample":
            raise KeyError(tag)
        self.key, k_res, self._k_mut = jax.random.split(self.key, 3)
        self.mut_keys = None
        return torch.tensor(float(jax.random.uniform(k_res, ())), dtype=torch.float32)

    def accept(self, tag, log_ratio, active=None, count=None):
        lr = log_ratio.detach().cpu().numpy().astype(np.float64)
        act = np.ones(lr.shape, bool) if active is None else active.cpu().numpy()
        self.last_active = act
        if tag in ("hmc.accept", "smc.accept"):
            u = np.asarray(_uniform(self.next_key))
        elif tag == "nuts.direction":
            k = np.asarray(_split4(self.next_key))
            self.next_key = np.where(act[:, None], k[:, 0], self.next_key)
            self.sub_key, self.merge_key = k[:, 2], k[:, 3]
            u = np.asarray(_uniform(k[:, 1]))
            dec = u < 0.5
            self.margins += list(np.abs(u - 0.5)[act])
            return torch.from_numpy(act & dec)
        elif tag == "nuts.leaf":
            k = np.asarray(_split2(self.sub_key))
            self.sub_key = np.where(act[:, None], k[:, 0], self.sub_key)
            u = np.asarray(_uniform(k[:, 1]))
        elif tag == "nuts.merge":
            u = np.asarray(_uniform(self.merge_key))
        else:
            raise KeyError(tag)
        log_u = np.log(u.astype(np.float32)).astype(np.float64)
        dec = log_u < lr
        close = act & np.isfinite(lr)
        self.margins += list(np.abs(log_u - lr)[close])
        return torch.from_numpy(act & dec)
