"""The P-VAE encoder and decoder (port of ``ct_pvae_tpu.models``)."""
