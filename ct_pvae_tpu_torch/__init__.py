"""PyTorch / CUDA port of ``ct_pvae_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference; every module here names its
counterpart there and is held against it by ``tests/test_torch_*.py``.  This
package imports torch, numpy and the standard library only, never JAX or the
JAX package.  Importing it builds no kernel: the CUDA projector, its
adjoint and the fused conv kernel are compiled with ``nvcc`` on their first
launch (``ops/_cuda.py``).

Slice 1 covers amortized serving (``python -m ct_pvae_tpu_torch.cli infer``),
slice 2 training (``python -m ct_pvae_tpu_torch.cli train``), slice 3 the
gather-projector route with the toy recipe (``--config configs/toy.yaml``)
and the fused conv probe (``python -m ct_pvae_tpu_torch.scripts.probe_conv_fused``),
slice 7 data generation (``python -m ct_pvae_tpu_torch.cli make-data``) and
the 512^2 stretch recipe (``--config configs/foam_stretch.yaml``), slice 8
the training options (``steps_per_call`` as a CUDA graph of the train step,
``train_pnm``, dropout, InstanceNorm, Beta latents and output, ``--det``,
``profile_steps``, ``conv_impl`` and bfloat16), slice 9 exact-posterior
MCMC (``python -m ct_pvae_tpu_torch.cli mcmc``: HMC, NUTS and SMC over a
batch of chains, the toy and image posteriors).
"""

__version__ = "0.1.0"
