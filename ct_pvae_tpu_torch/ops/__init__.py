"""Projectors and FBP (port of ``ct_pvae_tpu.ops``)."""
