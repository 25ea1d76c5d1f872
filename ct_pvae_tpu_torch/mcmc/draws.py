"""The samplers' random draws, named in the order the JAX samplers split their keys.

The JAX samplers thread a PRNG key and split it at fixed points; a chain
whose loop has ended under ``vmap`` keeps its key and draws nothing more.
The port's samplers ask a draw source for each draw by tag instead, in the
same order, and pass the mask of the chains still running:

  hmc.momentum, hmc.accept                       hmc.py:86-96
  nuts.momentum, nuts.direction, nuts.leaf,      nuts.py:253-255, 281-282,
  nuts.merge                                     166-167, 304
  smc.resample, smc.momentum, smc.accept         smc.py:42, 80-96, 146, 156

``SamplerDraws`` serves them from one ``torch.Generator`` on the chains'
device; a test can pass any object with the same three methods, such as a
source that walks JAX's own key tree (``tests/_torch_parity.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch

LOG_HALF = math.log(0.5)


class SamplerDraws:
    """Draws from one ``torch.Generator``; a masked-out chain consumes none."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def normal(self, tag: str, shape: Sequence[int], device: torch.device) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.gen, device=device)

    def uniform(self, tag: str, shape: Sequence[int], device: torch.device) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.gen, device=device)

    def accept(self, tag: str, log_ratio: torch.Tensor, active: Optional[torch.Tensor] = None,
               count: Optional[int] = None) -> torch.Tensor:
        """(C,) bools: True with probability min(1, exp(log_ratio)) for each
        chain of ``active`` (all when None), whose number ``count`` the
        caller knows on the host; False for the others."""
        if active is None:
            u = torch.rand(log_ratio.shape, generator=self.gen, device=log_ratio.device)
            return torch.log(u) < log_ratio
        u = torch.rand((count,), generator=self.gen, device=log_ratio.device)
        u = torch.ones_like(log_ratio).masked_scatter(active, u)
        return active & (torch.log(u) < log_ratio)


DrawSource = Union[torch.Generator, SamplerDraws]


def as_draws(source) -> SamplerDraws:
    """A draw source from a ``torch.Generator``, or ``source`` itself."""
    return SamplerDraws(source) if isinstance(source, torch.Generator) else source


def value_and_grad(log_prob_fn, z: torch.Tensor):
    """(log_prob_fn(z), its gradient in z), both detached: one batched
    evaluation of a ``(C, D) -> (C,)`` target and one backward pass."""
    with torch.enable_grad():
        zz = z.detach().requires_grad_(True)
        lp = log_prob_fn(zz)
        (g,) = torch.autograd.grad(lp.sum(), zz)
    return lp.detach(), g
