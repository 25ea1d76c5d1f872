"""Projectors, FBP, gridrec and the fused conv kernel (port of ``ct_pvae_tpu.ops`` and kernel E)."""
