"""The image-space posterior of one foam object (port of
``ct_pvae_tpu/mcmc/image_model.py``).

    log p(O | M)  =  log p(M | O) + log p(O) + const

with the true-Poisson likelihood of the masked sparse-angle sinogram through
the projector (the measurement model the data were made with), a pixel prior
(``tv``, ``smooth`` or ``flat``), and positivity through a softplus
bijector. Every target takes the chains as its batch: ``(C, H*W) -> (C,)``,
so each evaluation is one projector call over all chains (the Joseph
kernels' batch axis is the chain axis).

``Projector`` routes as ``make_projector`` does (image_model.py:96-134):
the fused Joseph projector (kernel A forward, B as its backward on a CUDA
tensor; its plain version on the CPU) when ``n_det >= 64`` and the image is
square, the gather ``radon`` otherwise or when ``use_pallas`` is False.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import joseph_radon
from ..ops.radon import FixedAngleRadon


def as_f32(x, device) -> torch.Tensor:
    """``x`` (a tensor, an array or a sequence) as a float32 tensor on ``device``."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)


def softplus_forward(x: torch.Tensor) -> torch.Tensor:
    return F.softplus(x)


def softplus_inverse(o: torch.Tensor) -> torch.Tensor:
    """x with softplus(x) = o (o > 0); stable for large o."""
    o = torch.clamp(o, min=1e-6)
    return o + torch.log(-torch.expm1(-o))


def softplus_log_det_jacobian(x: torch.Tensor) -> torch.Tensor:
    """sum over the last axis of log d softplus(x)/dx = log sigmoid(x)."""
    return F.logsigmoid(x).sum(-1)


def _grad_images(o: torch.Tensor):
    """Forward differences with a replicated last row and column (so 0 there);
    o is (..., H, W)."""
    dx = F.pad(o[..., 1:, :] - o[..., :-1, :], (0, 0, 0, 1))
    dy = F.pad(o[..., :, 1:] - o[..., :, :-1], (0, 1))
    return dx, dy


def image_log_prior(o: torch.Tensor, prior: str, weight: float) -> torch.Tensor:
    """log p(O) up to a constant for (..., H, W) nonnegative images:
    ``tv`` Charbonnier-smoothed isotropic total variation, ``smooth``
    0.5 * w * ||grad O||^2, ``flat`` the improper uniform (image_model.py:67-88)."""
    if prior == "flat":
        return o.new_zeros(o.shape[:-2])
    dx, dy = _grad_images(o)
    if prior == "tv":
        return -weight * torch.sqrt(dx * dx + dy * dy + 1e-6).sum((-2, -1))
    if prior == "smooth":
        return -0.5 * weight * (dx * dx + dy * dy).sum((-2, -1))
    raise ValueError(f"unknown prior {prior!r} (use tv | smooth | flat)")


class Projector:
    """(C, H, W) images -> (C, A_used, n_det) sinograms, linear, with its
    adjoint (image_model.py:96-134, ``make_projector``): the Joseph route for
    ``n_det >= 64`` and a square image unless ``use_pallas`` says otherwise,
    its adjoint kernel B (the plain version on the CPU); the gather ``radon``
    onto ``n_det`` bins otherwise, its adjoint the gather's VJP."""

    def __init__(self, theta_used, x_size: int, y_size: int, n_det: int,
                 use_pallas: Optional[bool] = None, device="cpu"):
        theta = np.asarray(torch.as_tensor(theta_used).cpu(), np.float32)
        self.joseph = (n_det >= 64 and x_size == y_size) if use_pallas is None else bool(use_pallas)
        self.n, self.n_det = x_size, n_det
        if self.joseph:
            table = joseph_radon.angle_table_fused(theta, x_size, y_size, n_det)
            self.rows = torch.as_tensor(joseph_radon.kernel_rows(table), device=device)
        else:
            self.gather = FixedAngleRadon(theta, x_size, y_size, pad=True, n_det=n_det, device=device)

    def __call__(self, o: torch.Tensor) -> torch.Tensor:
        if self.joseph:
            return joseph_radon.radon_fused(o.contiguous(), self.rows, self.n_det)
        return self.gather(o)

    def adjoint(self, sino: torch.Tensor, image_shape) -> torch.Tensor:
        if self.joseph:
            return joseph_radon.radon_fused_adjoint(sino.contiguous(), self.rows, self.n)
        with torch.enable_grad():
            o = sino.new_zeros(image_shape, requires_grad=True)
            (adj,) = torch.autograd.grad(self(o), o, grad_outputs=sino)
        return adj


class _RateFloor(torch.autograd.Function):
    """max(rate, 1e-30) with the gradient of ``jnp.maximum``: the incoming
    gradient times 1 above the floor, 1/2 at it and 0 below, by
    multiplication, so an infinite gradient below the floor turns NaN.  That
    is the reference's behaviour (ADVICE.md): a rate driven to 0 where
    photons were counted makes the log-prob -inf and its gradient NaN, which
    the NaN-blind divergence test lets pass; ``torch.clamp`` would give 0."""

    @staticmethod
    def forward(ctx, rate):
        ctx.save_for_backward(rate)
        return torch.clamp(rate, min=1e-30)

    @staticmethod
    def backward(ctx, grad):
        (rate,) = ctx.saved_tensors
        return grad * ((rate > 1e-30).to(grad.dtype) + 0.5 * (rate == 1e-30).to(grad.dtype))


def make_image_log_prob(
    measurements,                # (A_used, P) masked, dose-normalised noisy sinogram
    theta_used,                  # (A_used,) angles with nonzero mask
    mask_used,                   # (A_used,) the dose-normalisation values (1/nsa)
    poisson_noise_multiplier: float,
    x_size: int,
    y_size: int,
    prior: str = "tv",
    prior_weight: float = 10.0,
    use_pallas: Optional[bool] = None,
    device="cpu",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Unconstrained-space log-prob ``(C, x_size*y_size) -> (C,)`` of the image
    posterior (image_model.py:137-197); compose with ``softplus_forward`` to
    read images off samples.

    The likelihood is ``Poisson(proj * mask * pnm)`` scoring ``measurements
    * pnm`` in deviance form, k*log1p((rate - k)/k) - (rate - k) per bin: the
    Poisson log-pmf up to a constant in k, each term O(1) near the posterior
    bulk, and its log taken at a small argument. The raw log-pmf sums to ~1e8
    at 128^2 and pnm 1e4, where float32 resolves energy differences only to
    ~16 and the MH test drowns in cancellation.
    """
    dev = torch.device(device)
    meas = as_f32(measurements, dev)
    n_det = int(meas.shape[-1])
    mask = as_f32(mask_used, dev)[:, None]
    pnm = float(np.float32(poisson_noise_multiplier))
    project = Projector(theta_used, x_size, y_size, n_det, use_pallas, dev)
    counts = meas * pnm
    measured, counts_floor = counts > 0, torch.clamp(counts, min=1.0)

    def log_prob(x: torch.Tensor) -> torch.Tensor:
        o = softplus_forward(x).reshape(-1, x_size, y_size)
        rate = _RateFloor.apply(project(o) * mask * pnm)
        diff = rate - counts
        u = diff / counts_floor
        loglik = torch.where(measured, counts * torch.log1p(u) - diff, -rate).sum((-2, -1))
        return loglik + image_log_prior(o, prior, prior_weight) + softplus_log_det_jacobian(x)

    return log_prob


def positive_median(values: torch.Tensor) -> torch.Tensor:
    """The median of the positive entries, the mean of the two middle ones
    for an even count (``jnp.nanmedian``; ``torch.nanmedian`` takes the lower
    one); 1 when none is positive, at least 1e-12 otherwise."""
    pos = torch.sort(values[values > 0]).values
    k = pos.numel()
    if k == 0:
        return values.new_ones(())
    return torch.clamp(0.5 * pos[(k - 1) // 2] + 0.5 * pos[k // 2], min=1e-12)


def estimate_curvature_diag(
    x0: torch.Tensor,            # (D,) unconstrained point (e.g. the mean chain init)
    measurements,
    theta_used,
    mask_used,
    poisson_noise_multiplier: float,
    x_size: int,
    y_size: int,
    prior: str = "tv",
    prior_weight: float = 10.0,
    gen: Optional[torch.Generator] = None,
    num_probes: int = 64,
    floor_frac: float = 1e-3,
    use_pallas: Optional[bool] = None,
    probes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Diagonal curvature of -log p(x | M) at ``x0`` by Hutchinson's estimator
    (image_model.py:200-279): (D,) positive values, ``1/diag`` the NUTS metric.

    * Likelihood Gauss-Newton term E[v * J^T W J v], with J = d(counts)/dx =
      pnm * mask * A * diag(sigmoid(x)) and W = y / counts^2: one forward and
      one adjoint projector call over all probes at once.
    * Prior and softplus log-det term E[v * H v], H v by double backward.

    The Rademacher ``probes`` (num_probes, D) are drawn from ``gen`` unless
    given. Estimates at or below zero are raised to ``floor_frac`` times the
    median positive one.
    """
    x0 = as_f32(x0, None).detach()
    dev = x0.device
    meas = as_f32(measurements, dev)
    n_det = int(meas.shape[-1])
    mask = as_f32(mask_used, dev)[:, None]
    pnm = float(np.float32(poisson_noise_multiplier))
    project = Projector(theta_used, x_size, y_size, n_det, use_pallas, dev)
    if probes is None:
        probes = torch.randint(0, 2, (num_probes, x0.numel()), generator=gen, device=dev).float() * 2.0 - 1.0
    v = probes.to(device=dev, dtype=torch.float32)
    shape = (v.shape[0], x_size, y_size)

    def counts_of_image(o_flat):  # linear map (P, D) -> (P, A, n_det)
        return project(o_flat.reshape(-1, x_size, y_size)) * mask * pnm

    def local_neg_logp(x):  # -(prior + log-det), no projector
        o = softplus_forward(x).reshape(-1, x_size, y_size)
        return -(image_log_prior(o, prior, prior_weight) + softplus_log_det_jacobian(x))

    with torch.no_grad():
        s = torch.sigmoid(x0)                                  # d softplus / dx
        lam = torch.clamp(counts_of_image(softplus_forward(x0)[None]), min=1e-6)
        w = (meas * pnm) / (lam * lam)                         # Poisson: d2(-ll)/dlam2
        jv = counts_of_image(s * v)
        gn = s * project.adjoint(w * jv * pnm * mask, shape).reshape(v.shape)  # J^T W J v
    with torch.enable_grad():
        xb = x0.expand_as(v).clone().requires_grad_(True)
        (g,) = torch.autograd.grad(local_neg_logp(xb).sum(), xb, create_graph=True)
        (hv_local,) = torch.autograd.grad((g * v).sum(), xb)
    diag = (v * (gn + hv_local)).sum(0) / v.shape[0]
    return torch.clamp(diag, min=floor_frac * positive_median(diag))


def init_chains_from_recon(recon, num_chains: int, gen: torch.Generator, jitter: float = 0.05,
                           floor: float = 1e-3, device=None) -> torch.Tensor:
    """Chains at softplus^-1 of a classical reconstruction (H, W) plus
    ``jitter`` times a standard normal: (num_chains, H*W) unconstrained states
    (image_model.py:282-296)."""
    recon = as_f32(recon, device)
    x0 = softplus_inverse(torch.clamp(recon, min=floor))
    noise = torch.randn((num_chains,) + tuple(x0.shape), generator=gen, device=recon.device)
    return (x0[None] + jitter * noise).reshape(num_chains, -1)
