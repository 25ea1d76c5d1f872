"""Exact-posterior MCMC (port of ``ct_pvae_tpu/mcmc``): HMC, NUTS and SMC over
a batch of chains, the toy and image posteriors, and the diagnostics."""

from .diagnostics import effective_sample_size, split_rhat
from .hmc import HMCConfig, hmc_sample
from .nuts import NUTSConfig, nuts_sample
from .smc import SMCConfig, smc_sample
from .toy_model import toy_joint_log_prob, toy_posterior_sampler

__all__ = [
    "effective_sample_size",
    "split_rhat",
    "hmc_sample",
    "HMCConfig",
    "nuts_sample",
    "NUTSConfig",
    "smc_sample",
    "SMCConfig",
    "toy_joint_log_prob",
    "toy_posterior_sampler",
]
