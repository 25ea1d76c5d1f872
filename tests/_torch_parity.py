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
