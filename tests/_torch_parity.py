"""Shared helpers of the PyTorch-port parity tests (``tests/test_torch_*.py``).

The JAX package is the reference; both sides get the same numpy inputs.  The
JAX package's random draws are replayed into the port as tensors: ``jax_draws``
walks the key tree of ``ct_pvae_tpu/vi/loss.py:elbo_loss`` (training=False).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ct_pvae_tpu_torch.prob.distributions import EPS
from ct_pvae_tpu_torch.vi.loss import Draws


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
