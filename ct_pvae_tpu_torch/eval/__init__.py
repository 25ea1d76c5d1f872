"""Evaluation metrics (port of ``ct_pvae_tpu.eval``)."""
