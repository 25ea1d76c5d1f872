"""Physics-informed ELBO (port of ``ct_pvae_tpu/vi/loss.py`` ``elbo_loss``).

The chain M --encode--> q(z|M) --sample/decode--> p(R|z) --project--> p(M|R)
with the reference's quirks kept: the 1/300 encoder-input scale, a Normal q
per level with scale ``positive_range(log_scale) + EPS`` (or a Beta q of
``positive_range`` concentrations against a Beta(0.5, 0.5) prior), a
TruncatedNormal(0, 1e10) per-pixel output (or a Beta output whose log-prob
reads its sample clipped to [EPS, 1-EPS]), the negative-entropy term (the
output's log-prob of its own sample), the Gaussian approximation of the
Poisson likelihood, KL over levels 1..num_blocks and the /1e5 loss scale
(loss.py:53-227).  In deterministic mode the skips are the latents and the
KL is zero.  The S ELBO samples go through the decoder and the projector as
one merged, sample-major S*B batch: the counterpart of the JAX package's
``vmap`` over the samples, one decoder call where a Python loop would launch
S; a dropout mask drawn for the merged batch is independent per sample, as
the JAX package's per-sample dropout keys are.  In training the likelihood
runs on a subset of the angles (``angles_i``, loss.py:124-129) and the
posterior mean is not formed (``recon_mean`` is the samples' mean,
loss.py:170-172).

Random numbers come from a draw source.  ``Draws`` holds them as tensors, so
the tests can hand the port the JAX package's draws and a card step can be
replayed on the CPU; a ``torch.Generator`` (``GeneratorDraws``) draws them
on demand, inside the step, which is what lets a CUDA graph of the train
step draw anew on every replay from a generator re-seeded before it.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from ..prob.distributions import (
    EPS, Beta, Normal, TruncatedNormal, draw_log_gamma, kl_beta_beta, kl_normal_normal,
    positive_range,
)


class Draws(NamedTuple):
    eps: List[List[torch.Tensor]]  # [sample][level]: standard normal, NHWC latent shape
    u: List[torch.Tensor]          # [sample]: uniform on [EPS, 1-EPS), (B, x, y, 1)
    # Beta latents and output: log-gamma variates in the order the step asks
    # for them (per level a then b, then the output's a and b), each (S*B, ...)
    log_gamma: Optional[List[torch.Tensor]] = None
    keep: Optional[List[torch.Tensor]] = None  # dropout keep masks, in call order


def standard_draws(gen: torch.Generator, latent_shapes: Sequence[Tuple[int, ...]],
                   out_shape: Tuple[int, ...], num_samples: int, device: torch.device) -> Draws:
    """Per sample: a standard normal of each latent shape, then a uniform on
    [EPS, 1-EPS) of the output shape, drawn from ``gen`` on ``device``."""
    eps, u = [], []
    for _ in range(num_samples):
        eps.append([torch.randn(s, generator=gen, device=device) for s in latent_shapes])
        u.append(EPS + (1.0 - 2.0 * EPS) * torch.rand(out_shape, generator=gen, device=device))
    return Draws(eps, u)


class ReplayDraws:
    """The draw source of given ``Draws``: each request takes the next tensor."""

    def __init__(self, draws: Draws):
        self.draws = draws
        self._gamma = iter(draws.log_gamma or ())
        self._keep = iter(draws.keep or ())

    def latent_normals(self, level: int, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.cat([eps[level] for eps in self.draws.eps])

    def out_uniforms(self, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.cat(self.draws.u)

    def log_gamma(self, alpha: torch.Tensor) -> torch.Tensor:
        out = next(self._gamma, None)
        if out is None or out.shape != alpha.shape:
            raise ValueError(f"draws hold no log-gamma variates of shape {tuple(alpha.shape)}")
        return out

    def keep(self, shape: Tuple[int, ...], p: float) -> torch.Tensor:
        out = next(self._keep, None)
        if out is None or out.shape != shape:
            raise ValueError(f"draws hold no dropout mask of shape {tuple(shape)}")
        return out


class GeneratorDraws:
    """The draw source of a ``torch.Generator``, drawing on ``device`` on
    demand.  With ``record`` it keeps what it drew, and ``recorded`` returns
    it as ``Draws`` (to replay the same step elsewhere)."""

    def __init__(self, gen: torch.Generator, device: torch.device, record: bool = False):
        self.gen, self.device = gen, device
        self.log = {"eps": [], "u": [], "log_gamma": [], "keep": []} if record else None

    def _logged(self, kind: str, x: torch.Tensor) -> torch.Tensor:
        if self.log is not None:
            self.log[kind].append(x.detach().clone())
        return x

    def latent_normals(self, level: int, shape: Tuple[int, ...]) -> torch.Tensor:
        return self._logged("eps", torch.randn(shape, generator=self.gen, device=self.device))

    def out_uniforms(self, shape: Tuple[int, ...]) -> torch.Tensor:
        u = EPS + (1.0 - 2.0 * EPS) * torch.rand(shape, generator=self.gen, device=self.device)
        return self._logged("u", u)

    def log_gamma(self, alpha: torch.Tensor) -> torch.Tensor:
        return self._logged("log_gamma", draw_log_gamma(alpha, self.gen))

    def keep(self, shape: Tuple[int, ...], p: float) -> torch.Tensor:
        mask = torch.rand(shape, generator=self.gen, device=self.device) < 1.0 - p
        return self._logged("keep", mask)

    def recorded(self, num_samples: int) -> Draws:
        """What this source drew, as ``Draws`` (merged draws split per sample)."""
        split = lambda x: list(torch.chunk(x, num_samples))
        per_level = [split(e) for e in self.log["eps"]]
        eps = [[lv[s] for lv in per_level] for s in range(num_samples)] if per_level else []
        u = split(self.log["u"][0]) if self.log["u"] else []
        return Draws(eps, u, self.log["log_gamma"] or None, self.log["keep"] or None)


DrawSource = Union[ReplayDraws, GeneratorDraws]


def draw_source(draws: Union[Draws, DrawSource]) -> DrawSource:
    return ReplayDraws(draws) if isinstance(draws, Draws) else draws


class ElboAux(NamedTuple):
    loss: torch.Tensor                # scalar, reference-scaled
    kl: torch.Tensor                  # (B,) KL summed over levels 1..num_blocks
    loglik: torch.Tensor              # scalar: mean over samples of the total log p(M, R)
    log_prob_M_given_R: torch.Tensor  # scalar, physics term of the last sample
    log_prob_R_given_z: torch.Tensor  # scalar, negative-entropy term of the last sample
    recon_sample: torch.Tensor        # (B, x, y), the last sample
    recon_mean: torch.Tensor          # (B, x, y), output mean averaged over samples
    # the last sample's output distribution parameters, each (B, x, y, 1):
    # TruncatedNormal loc and scale, or Beta concentrations
    recon_params: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def physics_log_likelihood(
    proj: torch.Tensor,         # (B, A, P) projection of the reconstruction
    mask: torch.Tensor,         # (B, A) dose-normalised mask
    proj_sample: torch.Tensor,  # (B, A, P) measured sparse sinogram
    pnm: torch.Tensor,          # Poisson noise multiplier (annealed)
) -> torch.Tensor:
    """log p(M | R) under the Gaussian-approximate Poisson model; (B, A, P)."""
    proj_masked = proj * mask[:, :, None]
    scale = EPS + torch.sqrt(proj_masked / pnm + EPS)
    return Normal(proj_masked, scale).log_prob(proj_sample)


def _repeat(x: torch.Tensor, s: int) -> torch.Tensor:
    return x.repeat((s,) + (1,) * (x.dim() - 1))


def elbo_loss(
    encoder: torch.nn.Module,
    decoder: torch.nn.Module,
    input_encode: torch.Tensor,   # (B, x, y, C)
    mask: torch.Tensor,           # (B, A)
    proj_sample: torch.Tensor,    # (B, A, P)
    draws: Union[Draws, DrawSource],
    *,
    project_fn: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor],
    angles_i: Optional[torch.Tensor] = None,  # (A_sub,) indices, None for all angles
    kl_anneal,
    kl_multiplier: float,
    pnm: torch.Tensor,
    num_blocks: int,
    num_samples: Optional[int] = None,
    use_normal: bool = True,
    deterministic: bool = False,
    input_encode_scale: float = 300.0,
    loss_scale: float = 1e5,
    training: bool = False,
):
    """(loss, ElboAux) of ``elbo_loss``.

    ``project_fn(recon, angles_i)`` maps (S*B, x, y) to (S*B, A_sub, P).
    ``num_samples`` defaults to the number of samples in ``Draws``.  In
    training the models draw their dropout masks from the source.
    """
    src = draw_source(draws)
    s = len(draws.eps) if num_samples is None else num_samples
    if angles_i is not None:
        mask = mask.index_select(1, angles_i)
        proj_sample = proj_sample.index_select(1, angles_i)
    keep = src.keep if training else None
    skips = encoder(input_encode / input_encode_scale, keep=keep)
    b = input_encode.shape[0]
    qs = []
    if deterministic:
        latents = [_repeat(z, s) for z in skips]
    else:
        for z in skips:
            loc, log_scale = torch.chunk(z, 2, dim=-1)
            scale = positive_range(log_scale)
            qs.append(Normal(loc, scale + EPS) if use_normal else Beta(positive_range(loc), scale))
        latents = []
        # every level's S draws stacked sample-major: (S*B, ...)
        for level, q in enumerate(qs):
            if use_normal:
                loc, scale = _repeat(q.loc, s), _repeat(q.scale, s)
                latents.append(Normal(loc, scale).sample(src.latent_normals(level, loc.shape)))
            else:
                qa, qb = _repeat(q.a, s), _repeat(q.b, s)
                latents.append(Beta(qa, qb).sample(src.log_gamma(qa), src.log_gamma(qb)))
    alpha, beta_p = decoder(latents, keep=keep)
    out_params = (positive_range(alpha), positive_range(beta_p))
    if use_normal:
        out_dist = TruncatedNormal(*out_params, 0.0, 1e10)
        out_sample = out_dist.sample(src.out_uniforms(alpha.shape))
        lp_out = out_dist.log_prob(out_sample)
    else:
        out_dist = Beta(*out_params)
        out_sample = out_dist.sample(src.log_gamma(out_dist.a), src.log_gamma(out_dist.b))
        lp_out = out_dist.log_prob(torch.clamp(out_sample, EPS, 1.0 - EPS))
    lp_selfs = lp_out.reshape(s, -1).sum(dim=1)
    merged = out_sample[..., 0]  # (S*B, x, y), sample-major
    recons = merged.reshape((s, b) + merged.shape[1:])
    recon_means = recons if training else out_dist.mean()[..., 0].reshape(recons.shape)

    lp_phys = physics_log_likelihood(
        project_fn(merged, angles_i), mask.repeat(s, 1), proj_sample.repeat(s, 1, 1), pnm
    )
    lp_physs = lp_phys.reshape(s, -1).sum(dim=1)
    lps = lp_physs + lp_selfs
    loglik = lps.mean()

    if deterministic:
        kl = torch.zeros(b, dtype=torch.float32, device=input_encode.device)
    elif use_normal:
        prior = lambda q: Normal(torch.zeros_like(q.loc), torch.ones_like(q.scale))
        kl = sum(kl_normal_normal(qs[i], prior(qs[i])).sum(dim=(1, 2, 3))
                 for i in range(1, num_blocks + 1))
    else:
        prior = lambda q: Beta(torch.full_like(q.a, 0.5), torch.full_like(q.b, 0.5))
        kl = sum(kl_beta_beta(qs[i], prior(qs[i])).sum(dim=(1, 2, 3))
                 for i in range(1, num_blocks + 1))
    loss = torch.mean(kl_anneal * kl_multiplier * kl - loglik) / loss_scale
    return loss, ElboAux(
        loss=loss,
        kl=kl,
        loglik=loglik,
        log_prob_M_given_R=lp_physs[-1],
        log_prob_R_given_z=lp_selfs[-1],
        recon_sample=recons[-1],
        recon_mean=recon_means.mean(dim=0),
        recon_params=tuple(t.reshape((s, b) + t.shape[1:])[-1] for t in out_params),
    )
