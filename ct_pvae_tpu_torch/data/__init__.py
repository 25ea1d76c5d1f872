"""Data loading and the measurement model (port of ``ct_pvae_tpu.data``)."""
