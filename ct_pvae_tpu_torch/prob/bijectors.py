"""Bijectors for constrained MCMC (port of ``ct_pvae_tpu/prob/bijectors.py``).

``IteratedSigmoidCentered`` (bijectors.py:17-72): the stick-breaking map of
TFP's bijector of that name, which the reference's toy HMC runs through
(bin/toy_mcmc_v2.py:102-104), on the last axis of ``(..., n)`` tensors.
"""

from __future__ import annotations

import torch


def _offset(n: int, like: torch.Tensor) -> torch.Tensor:
    """-log(n - i) for i = 0 .. n-1: centres x = 0 on the uniform vector."""
    return -torch.log(torch.arange(n, 0, -1, dtype=like.dtype, device=like.device))


def _sticks(x: torch.Tensor):
    """(z, r_shifted): z_i = sigmoid(x_i + offset_i), r_i = prod_{j<i} (1 - z_j)."""
    z = torch.sigmoid(x + _offset(x.shape[-1], x))
    r = torch.cumprod(1.0 - z, dim=-1)
    r_shifted = torch.cat([torch.ones_like(r[..., :1]), r[..., :-1]], dim=-1)
    return z, r, r_shifted


class IteratedSigmoidCentered:
    """Stick-breaking map R^n -> interior of the (n+1)-simplex, x = 0 to the
    uniform vector:

        y_i = z_i * r_i  (i < n),   y_n = r_n

    ``forward_log_det_jacobian`` is the log-volume change onto the first n
    coordinates (the last one is fixed by the constraint).
    """

    @staticmethod
    def forward(x: torch.Tensor) -> torch.Tensor:
        z, r, r_shifted = _sticks(x)
        return torch.cat([z * r_shifted, r[..., -1:]], dim=-1)

    @staticmethod
    def inverse(y: torch.Tensor) -> torch.Tensor:
        head = y[..., :-1]
        csum = torch.cumsum(head, dim=-1)
        r = 1.0 - torch.cat([torch.zeros_like(csum[..., :1]), csum[..., :-1]], dim=-1)
        z = torch.clamp(head / torch.clamp(r, min=1e-30), 1e-12, 1.0 - 1e-12)
        return torch.logit(z) - _offset(head.shape[-1], y)

    @staticmethod
    def forward_log_det_jacobian(x: torch.Tensor) -> torch.Tensor:
        return IteratedSigmoidCentered.forward_and_log_det(x)[1]

    @staticmethod
    def forward_and_log_det(x: torch.Tensor):
        """(forward(x), forward_log_det_jacobian(x)) from one stick computation."""
        z, r, r_shifted = _sticks(x)
        y = torch.cat([z * r_shifted, r[..., -1:]], dim=-1)
        # dy_i/dx_i = z_i (1 - z_i) r_i; the Jacobian is triangular
        return y, (torch.log(z) + torch.log1p(-z) + torch.log(torch.clamp(r_shifted, min=1e-30))).sum(-1)
