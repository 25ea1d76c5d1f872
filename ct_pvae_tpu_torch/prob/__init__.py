"""Distributions for the ELBO (port of ``ct_pvae_tpu.prob``)."""
