"""Physics-informed ELBO (port of ``ct_pvae_tpu/vi/loss.py`` ``elbo_loss``).

The chain M --encode--> q(z|M) --sample/decode--> p(R|z) --project--> p(M|R)
with the reference's quirks kept: the 1/300 encoder-input scale, a Normal q
per level with scale ``positive_range(log_scale) + EPS``, a
TruncatedNormal(0, 1e10) per-pixel output, the negative-entropy term (the
output's log-prob of its own sample), the Gaussian approximation of the
Poisson likelihood, KL over levels 1..num_blocks and the /1e5 loss scale
(loss.py:53-227).  The S ELBO samples go through the projector as one merged
S*B batch.  In training the likelihood runs on a subset of the angles
(``angles_i``, loss.py:124-129) and the posterior mean is not formed
(``recon_mean`` is the samples' mean, loss.py:170-172).

Random draws come in as tensors (``Draws``) so the tests can hand the port
the JAX package's draws.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..prob.distributions import EPS, Normal, TruncatedNormal, kl_normal_normal, positive_range


class Draws(NamedTuple):
    eps: List[List[torch.Tensor]]  # [sample][level]: standard normal, NHWC latent shape
    u: List[torch.Tensor]          # [sample]: uniform on [EPS, 1-EPS), (B, x, y, 1)


def standard_draws(gen: torch.Generator, latent_shapes: Sequence[Tuple[int, ...]],
                   out_shape: Tuple[int, ...], num_samples: int, device: torch.device) -> Draws:
    """Per sample: a standard normal of each latent shape, then a uniform on
    [EPS, 1-EPS) of the output shape, drawn from ``gen`` on ``device``."""
    eps, u = [], []
    for _ in range(num_samples):
        eps.append([torch.randn(s, generator=gen, device=device) for s in latent_shapes])
        u.append(EPS + (1.0 - 2.0 * EPS) * torch.rand(out_shape, generator=gen, device=device))
    return Draws(eps, u)


class ElboAux(NamedTuple):
    loss: torch.Tensor                # scalar, reference-scaled
    kl: torch.Tensor                  # (B,) KL summed over levels 1..num_blocks
    loglik: torch.Tensor              # scalar: mean over samples of the total log p(M, R)
    log_prob_M_given_R: torch.Tensor  # scalar, physics term of the last sample
    log_prob_R_given_z: torch.Tensor  # scalar, negative-entropy term of the last sample
    recon_sample: torch.Tensor        # (B, x, y), the last sample
    recon_mean: torch.Tensor          # (B, x, y), output mean averaged over samples


def physics_log_likelihood(
    proj: torch.Tensor,         # (B, A, P) projection of the reconstruction
    mask: torch.Tensor,         # (B, A) dose-normalised mask
    proj_sample: torch.Tensor,  # (B, A, P) measured sparse sinogram
    pnm: torch.Tensor,          # Poisson noise multiplier (annealed)
) -> torch.Tensor:
    """log p(M | R) under the Gaussian-approximate Poisson model; (B, A, P)."""
    proj_masked = proj * mask[:, :, None]
    scale = EPS + torch.sqrt(proj_masked / pnm + EPS)
    return Normal(proj_masked, scale).log_prob(proj_sample)


def elbo_loss(
    encoder: torch.nn.Module,
    decoder: torch.nn.Module,
    input_encode: torch.Tensor,   # (B, x, y, C)
    mask: torch.Tensor,           # (B, A)
    proj_sample: torch.Tensor,    # (B, A, P)
    draws: Draws,
    *,
    project_fn: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor],
    angles_i: Optional[torch.Tensor] = None,  # (A_sub,) indices, None for all angles
    kl_anneal: float,
    kl_multiplier: float,
    pnm: torch.Tensor,
    num_blocks: int,
    input_encode_scale: float = 300.0,
    loss_scale: float = 1e5,
    training: bool = False,
):
    """(loss, ElboAux) of ``elbo_loss`` for Normal latents.

    ``project_fn(recon, angles_i)`` maps (S*B, x, y) to (S*B, A_sub, P).
    """
    if angles_i is not None:
        mask = mask.index_select(1, angles_i)
        proj_sample = proj_sample.index_select(1, angles_i)
    skips = encoder(input_encode / input_encode_scale)
    qs = []
    for s in skips:
        loc, log_scale = torch.chunk(s, 2, dim=-1)
        qs.append(Normal(loc, positive_range(log_scale) + EPS))

    lp_selfs, recons, recon_means = [], [], []
    for eps, u in zip(draws.eps, draws.u):
        latents = [q.sample(e) for q, e in zip(qs, eps)]
        alpha, beta_p = decoder(latents)
        out_dist = TruncatedNormal(positive_range(alpha), positive_range(beta_p), 0.0, 1e10)
        out_sample = out_dist.sample(u)
        lp_selfs.append(torch.sum(out_dist.log_prob(out_sample)))
        recons.append(out_sample[..., 0])
        recon_means.append(recons[-1] if training else out_dist.mean()[..., 0])

    s = len(recons)
    merged = torch.cat(recons, dim=0)  # (S*B, x, y), sample-major
    lp_phys = physics_log_likelihood(
        project_fn(merged, angles_i), mask.repeat(s, 1), proj_sample.repeat(s, 1, 1), pnm
    )
    lp_physs = lp_phys.reshape(s, -1).sum(dim=1)
    lps = lp_physs + torch.stack(lp_selfs)
    loglik = lps.mean()

    prior = lambda q: Normal(torch.zeros_like(q.loc), torch.ones_like(q.scale))
    kl = sum(
        kl_normal_normal(qs[i], prior(qs[i])).sum(dim=(1, 2, 3)) for i in range(1, num_blocks + 1)
    )
    loss = torch.mean(kl_anneal * kl_multiplier * kl - loglik) / loss_scale
    return loss, ElboAux(
        loss=loss,
        kl=kl,
        loglik=loglik,
        log_prob_M_given_R=lp_physs[-1],
        log_prob_R_given_z=lp_selfs[-1],
        recon_sample=recons[-1],
        recon_mean=torch.stack(recon_means).mean(dim=0),
    )
