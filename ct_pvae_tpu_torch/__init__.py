"""PyTorch / CUDA port of ``ct_pvae_tpu`` for one NVIDIA H100.

The JAX package beside it is the reference; every module here names its
counterpart there and is held against it by ``tests/test_torch_*.py``.  This
package imports torch, numpy and the standard library only, never JAX or the
JAX package.  Importing it builds no kernel: the CUDA projector is compiled
with ``nvcc`` on its first launch (``ops/_cuda.py``).

Slice 1 covers amortized serving (``python -m ct_pvae_tpu_torch.cli infer``).
"""

__version__ = "0.1.0"
