"""The toy 2x2 posterior, the exact-posterior MCMC baseline (port of
``ct_pvae_tpu/mcmc/toy_model.py``).

A Dirichlet-mixture prior over the 4-simplex times a true-Poisson
likelihood of the masked measurements through the gather projector
(reference ctvae/toy_mcmc_v2_functions.py:30-98), sampled in unconstrained
R^3 through ``IteratedSigmoidCentered``. Every sampler target takes a batch
of chains: ``(C, 4)`` simplex points or ``(C, 3)`` unconstrained ones.
``analytic_discrete_posterior`` is the exact two-object posterior of the
discrete toy dataset, which ``eval/pixel_dist.py`` draws beside the VAE's.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..ops.radon import FixedAngleRadon
from ..prob.bijectors import IteratedSigmoidCentered
from ..prob.distributions import Poisson, toy_prior

_TINY = float(torch.finfo(torch.float32).tiny)


def toy_joint(
    measurements: torch.Tensor,    # (A_used, P) masked, dose-normalised measurements
    theta_used: torch.Tensor,      # (A_used,)
    mask_used: torch.Tensor,       # (A_used,)
    poisson_noise_multiplier: float,
    n_pixel: int = 2,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``toy_joint_log_prob`` at fixed measurements, as a function of
    ``(C, 4)`` simplex points, with the prior and the projector's taps built once."""
    prior = toy_prior().to(measurements.device)
    project = FixedAngleRadon(theta_used, n_pixel, n_pixel, device=measurements.device)
    counts = measurements * poisson_noise_multiplier

    def log_prob(o_flat: torch.Tensor) -> torch.Tensor:
        o = torch.clamp(o_flat, min=_TINY)
        proj = project(o.reshape(-1, n_pixel, n_pixel))  # (C, A_used, P)
        lik = Poisson(proj * mask_used[:, None] * poisson_noise_multiplier)
        return prior.log_prob(o) + lik.log_prob(counts).sum((-2, -1))

    return log_prob


def toy_joint_log_prob(o_flat, measurements, theta_used, mask_used, poisson_noise_multiplier,
                       n_pixel: int = 2) -> torch.Tensor:
    """log P(O) + log P(M | O) of (C, 4) points (reference toy_mcmc_v2_functions.py:66-98)."""
    return toy_joint(measurements, theta_used, mask_used, poisson_noise_multiplier, n_pixel)(o_flat)


def toy_posterior_sampler(
    measurements: torch.Tensor,
    theta_used: torch.Tensor,
    mask_used: torch.Tensor,
    poisson_noise_multiplier: float = 1e3,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Unconstrained-space log-prob ``(C, 3) -> (C,)`` for HMC/NUTS over the toy posterior."""
    bij = IteratedSigmoidCentered
    joint = toy_joint(measurements, theta_used, mask_used, poisson_noise_multiplier)

    def log_prob(x: torch.Tensor) -> torch.Tensor:
        o, log_det = bij.forward_and_log_det(x)
        return joint(o) + log_det

    return log_prob


def analytic_discrete_posterior(
    proj_sample: torch.Tensor,   # (A, P) the noisy masked measurement
    mask: torch.Tensor,          # (A,)
    sinogram_0: torch.Tensor,    # (A, P) clean sinogram of object 0
    sinogram_1: torch.Tensor,    # (A, P) clean sinogram of object 1
    poisson_noise_multiplier: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """P(O_i | M) of the two discrete toy objects under equal priors: the
    softmax of their Poisson log-likelihoods (toy_model.py:61-87; the
    reference's ratio of log-likelihoods with hard-coded object indices,
    main_ct_vae.py:689-705, is not kept)."""
    counts = proj_sample * poisson_noise_multiplier

    def loglik(sino: torch.Tensor) -> torch.Tensor:
        return Poisson(sino * mask[:, None] * poisson_noise_multiplier).log_prob(counts).sum()

    post = torch.softmax(torch.stack([loglik(sinogram_0), loglik(sinogram_1)]), dim=0)
    return post[0], post[1]
