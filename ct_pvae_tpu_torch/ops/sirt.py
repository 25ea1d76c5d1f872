"""SIRT with an injected projector pair (port of ``ops/sirt.py`` ``sirt_with_ops``).

    x_{k+1} = relu( x_k + C A^T R (p - A x_k) )

with row/column inverse-sum normalisers R = 1/(A 1), C = 1/(A^T 1)
(sirt.py:25-53); a Python loop takes the place of ``lax.scan``.  The
classical-init stack runs it on the static Joseph pair, kernels C and D.
"""

from __future__ import annotations

from typing import Callable

import torch

Op = Callable[[torch.Tensor], torch.Tensor]


def sirt_with_ops(
    sinogram: torch.Tensor,
    fwd: Op,
    adj: Op,
    x_size: int,
    y_size: int,
    num_iter: int = 30,
    eps: float = 1e-6,
) -> torch.Tensor:
    """SIRT reconstruction (..., A, P) -> (..., x_size, y_size): 1 + num_iter
    applications of ``fwd`` and of ``adj``."""
    ones_img = torch.ones(sinogram.shape[:-2] + (x_size, y_size), dtype=sinogram.dtype,
                          device=sinogram.device)
    r = 1.0 / torch.clamp(fwd(ones_img), min=eps)                    # 1 / (A 1)
    c = 1.0 / torch.clamp(adj(torch.ones_like(sinogram)), min=eps)   # 1 / (A^T 1)
    x = torch.zeros_like(ones_img)
    for _ in range(num_iter):
        resid = sinogram - fwd(x)
        x = torch.relu(x + c * adj(r * resid))
    return x
