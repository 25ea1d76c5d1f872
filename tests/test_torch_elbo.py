"""Port's eval-mode ELBO (vi/loss.py) against the JAX package's
``elbo_loss(..., training=False)`` with kernel A in Pallas interpret mode as
the projector, on the same params and the same draws."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import jax_draws
from ct_pvae_tpu.config import Config as JaxConfig
from ct_pvae_tpu.models.pvae import build_models as jax_build_models
from ct_pvae_tpu.ops.pallas_radon import angle_table_fused, radon_pallas_fused
from ct_pvae_tpu.vi.loss import elbo_loss
from ct_pvae_tpu_torch.config import Config
from ct_pvae_tpu_torch.models.pvae import build_models, params_from_flax
from ct_pvae_tpu_torch.ops.joseph_radon import radon_fused
from ct_pvae_tpu_torch.vi.loss import elbo_loss as torch_elbo_loss

HW, N_DET, B, C = 32, 48, 2, 3


def test_eval_elbo_matches_jax():
    kw = dict(num_blocks=2, num_feature_maps=6, kernel_size=4, stride_encode=2,
              intermediate_layers=1, intermediate_kernel=4, num_samples=2,
              algorithms=["fbp", "gridrec"])
    cfg_j, cfg_t = JaxConfig(**kw), Config(**kw)
    rng = np.random.default_rng(0)
    theta_all = np.linspace(0, np.pi, 180, endpoint=False)
    idx = np.sort(rng.choice(180, 12, replace=False))
    theta = theta_all[idx].astype(np.float32)
    table = angle_table_fused(theta, HW, HW, N_DET)  # unpadded recon, as train.py:272-283
    inputs = rng.uniform(0, 0.5, (B, HW, HW, C)).astype(np.float32)
    mask = np.zeros((B, 12), np.float32)
    mask[:, ::3] = 0.25
    proj = (rng.uniform(0, 20, (B, 12, N_DET)) * mask[:, :, None]).astype(np.float32)
    pnm, kl_anneal = 1e3, 1.0

    enc_j, dec_j, shapes = jax_build_models(HW, HW, C, cfg_j)
    k1, k2, key = jax.random.split(jax.random.PRNGKey(1), 3)
    p_enc = enc_j.init({"params": k1}, jnp.asarray(inputs))["params"]
    lat = [jnp.split(s, 2, axis=-1)[0] for s in enc_j.apply({"params": p_enc}, jnp.asarray(inputs))]
    p_dec = dec_j.init({"params": k2}, lat)["params"]
    params = {"encoder": p_enc, "decoder": p_dec}

    batch = {"input_encode": jnp.asarray(inputs), "mask": jnp.asarray(mask),
             "proj_sample": jnp.asarray(proj)}
    tab_j = jnp.asarray(table)
    jax_eval = jax.jit(lambda p, bt, k: elbo_loss(
        p, bt, k, encoder=enc_j, decoder=dec_j, theta=jnp.asarray(theta),
        angles_i=jnp.arange(12), kl_anneal=jnp.float32(kl_anneal), kl_multiplier=1.0,
        pnm=jnp.float32(pnm), num_samples=2, use_normal=True, deterministic=False,
        num_blocks=2, pad=True, n_det=N_DET, training=False,
        project_fn=lambda r, ai: radon_pallas_fused(r, tab_j[ai], N_DET, True),
    ))
    loss_j, aux_j = jax_eval(params, batch, key)

    enc, dec, shapes_t = build_models(HW, HW, C, cfg_t)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    enc.load_state_dict(params_from_flax(np_params["encoder"]))
    dec.load_state_dict(params_from_flax(np_params["decoder"]))
    latent_shapes = [(B, x, y, z // 2) for (x, y, z) in shapes_t]
    draws = jax_draws(key, latent_shapes, (B, HW, HW, 1), 2)
    tab_t = torch.from_numpy(table)
    with torch.no_grad():
        loss_t, aux_t = torch_elbo_loss(
            enc, dec, torch.from_numpy(inputs), torch.from_numpy(mask), torch.from_numpy(proj),
            draws, project_fn=lambda r, ai: radon_fused(r, tab_t, N_DET), kl_anneal=kl_anneal,
            kl_multiplier=1.0, pnm=torch.tensor(pnm, dtype=torch.float32), num_blocks=2,
        )

    close = lambda t, j: np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=0)
    close(loss_t, loss_j)
    close(aux_t.kl, aux_j.kl)
    close(aux_t.loglik, aux_j.loglik)
    close(aux_t.log_prob_M_given_R, aux_j.log_prob_M_given_R)
    close(aux_t.log_prob_R_given_z, aux_j.log_prob_R_given_z)
    # reconstructions in [0, ~1]: rtol 1e-4 with an absolute floor for near-zero pixels
    np.testing.assert_allclose(aux_t.recon_mean.numpy(), np.asarray(aux_j.recon_mean), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(aux_t.recon_sample.numpy(), np.asarray(aux_j.recon_sample), rtol=1e-4, atol=1e-6)
