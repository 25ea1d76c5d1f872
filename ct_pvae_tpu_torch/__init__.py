"""PyTorch / CUDA port of ``ct_pvae_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference; every module here names its
counterpart there and is held against it by ``tests/test_torch_*.py``.  This
package imports torch, numpy and the standard library only, never JAX or the
JAX package.  Importing it builds no kernel: the CUDA projector and its
adjoint are compiled with ``nvcc`` on their first launch (``ops/_cuda.py``).

Slice 1 covers amortized serving (``python -m ct_pvae_tpu_torch.cli infer``),
slice 2 training (``python -m ct_pvae_tpu_torch.cli train``).
"""

__version__ = "0.1.0"
