"""Plain reference of the P-VAE (arXiv:2211.00002): model, ELBO, optimiser, set-up.

Written from the paper's equations and its code's conventions, in plain
PyTorch float32; it imports nothing of the program.  The benchmark draws the
weights (``draw_weights``) and hands the same tensors to the program and to
this reference; the reference works everything else out again from the
configuration, the sinograms and the seed.

Model.  A conv block is a maxout pair: one convolution with 2F outputs whose
halves are max-ed.  A forward conv pads periodically so that a VALID conv
maps size s to ceil(s / stride) (the larger half of the pad in front); a
transposed conv (stride 2, kernel 4) keeps the stride x size window of its
full output that starts one pixel in.  The encoder repeats each input
channel twice and runs ``il`` stride-1 blocks and one stride-``se`` block per
level, keeping every level's activation; the decoder climbs back with a
transposed block and ``il`` stride-1 blocks per level, centre-crops to the
level's size and concatenates that level's latent (not at the input level),
and ends in a stride-1 head of two outputs (mean and scale maps).

Stored weights (``weight_shape``): a forward conv (2F, C, k, k), a transposed
conv (C, 2F, k, k) as ``conv_transpose2d`` reads it, a bias (2F); each
maxout half is drawn Glorot-uniform over its fans, biases are zero.

ELBO.  Each level's activation splits into (loc, log_scale); q is
Normal(loc, positive_range(log_scale) + EPS); S draws of every level, sample
major; the output is TruncatedNormal(positive_range(mean), positive_range(scale),
0, 1e10) drawn by its inverse CDF; the likelihood is the Gaussian
approximation of the Poisson count, Normal(A x m, EPS + sqrt(A x m / pnm +
EPS)) of the measurement on the step's angles; the loss is
mean_b(KL_b - mean_s(log p(M|R) + log q(R|z))) / 1e5 with KL over levels 1..nb.

Draws.  A step's draws come from a ``torch.Generator`` seeded from (seed,
"train", step) as a SeedSequence, in this order: a standard normal of each
level's latent shape (S*B, x, y, z/2), then a uniform on [EPS, 1 - EPS) of
the output shape (S*B, x, y, 1).  Serving draws from one generator seeded
seed + 7 for the whole request, batch by batch and pass by pass.

Optimiser.  NaN gradients to zero, each maxout half of each weight and bias
clipped to norm 100, then Adam (b1 0.9, b2 0.999) with float32 bias
corrections and m_hat / (sqrt(v_hat) + eps).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .projector import JosephMatrix, init_stack, tf32_round

EPS = float(np.finfo(np.float32).eps)
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
B1, B2 = 0.9, 0.999


class Block(NamedTuple):
    transpose: bool
    in_ch: int
    features: int
    kernel: int
    stride: int


class Sizes(NamedTuple):
    x: int            # reconstruction side
    n_det: int        # detector bins
    in_ch: int        # init channels (algorithms + mask)
    levels: List[Tuple[int, int, int]]   # (x, y, channels) of each encoder level
    encoder: List[Block]
    decoder: List[Block]


def recon_side(n_det: int) -> int:
    return int(np.floor(n_det / np.sqrt(2) - 2))


def detector_bins(n_pixel: int) -> int:
    """ceil((sqrt(2) n + 2) / 2) * 2 bins for an n x n object."""
    return int(math.ceil((math.sqrt(2.0 * n_pixel * n_pixel) + 2.0) / 2.0) * 2)


def model_sizes(cfg: Dict) -> Sizes:
    """Block shapes of the configuration ``cfg`` (the harness's config file)."""
    n_det = detector_bins(cfg["n_pixel"])
    x = recon_side(n_det)
    in_ch = len(cfg["algorithms"]) + 1
    k, s, il, ik = cfg["kernel_size"], cfg["stride_encode"], cfg["intermediate_layers"], cfg[
        "intermediate_kernel"]
    feats = [2 * int(cfg["num_feature_maps"] * cfg["num_feature_maps_multiplier"] ** i)
             for i in range(cfg["num_blocks"])]
    levels = [(x, x, 2 * in_ch)]
    side = x
    for f in feats:
        side = -(-side // s)
        levels.append((side, side, f))
    enc, ch = [], 2 * in_ch
    for f in feats:
        enc += [Block(False, ch, ch, ik, 1)] * il + [Block(False, ch, f, k, s)]
        ch = f
    lat = [z // 2 for (_, _, z) in levels]
    dec, ch = [], lat[-1]
    for i in range(len(levels) - 2, -1, -1):
        z = levels[i][2]
        dec += [Block(True, ch, z, k, s)] + [Block(False, z, z, ik, 1)] * il
        ch = z + (lat[i] if i > 0 else 0)
    dec.append(Block(False, ch, 2, k, 1))
    return Sizes(x, n_det, in_ch, levels, enc, dec)


def weight_shape(b: Block) -> Tuple[int, ...]:
    return ((b.in_ch, 2 * b.features) if b.transpose else (2 * b.features, b.in_ch)) + (
        b.kernel, b.kernel)


def draw_weights(sizes: Sizes, seed: int, device: torch.device) -> Dict[str, List[torch.Tensor]]:
    """{"encoder": [w0, b0, w1, b1, ...], "decoder": [...]}: one uniform draw
    on ``device`` from a generator seeded ``seed``, cut into the blocks'
    weights (each maxout half Glorot-uniform over its fans k k C and k k F),
    biases zero."""
    blocks = sizes.encoder + sizes.decoder
    total = sum(int(np.prod(weight_shape(b))) for b in blocks)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, lo = {"encoder": [], "decoder": []}, 0
    for i, b in enumerate(blocks):
        shape = weight_shape(b)
        n = int(np.prod(shape))
        limit = math.sqrt(6.0 / (b.kernel * b.kernel * (b.in_ch + b.features)))
        side = "encoder" if i < len(sizes.encoder) else "decoder"
        out[side] += [u[lo:lo + n].view(shape) * limit,
                      torch.zeros(2 * b.features, device=device)]
        lo += n
    return out


def leaves(block: Block, name: str, t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The two maxout halves of a block's weight or bias (the optimiser's leaves)."""
    dim = 1 if name == "weight" and block.transpose else 0
    return torch.split(t, block.features, dim=dim)


def _shrink_pad(size: int, stride: int, kernel: int) -> Tuple[int, int]:
    rem = size % stride
    pad = kernel - rem if rem else kernel - stride
    return (pad // 2 + pad % 2, pad // 2)


class _Operand(torch.autograd.Function):
    """A conv operand as TF32 reads it; the gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _OutputGrad(torch.autograd.Function):
    """Identity whose backward hands the conv's gradients the TF32-rounded
    output gradient (what the input- and weight-gradient convs read)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return tf32_round(g)


def _conv_block(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, blk: Block,
                tf32: bool) -> torch.Tensor:
    if tf32:  # the control: every product of the conv and its gradients on TF32 operands
        x, w = _Operand.apply(x), _Operand.apply(w)
    if blk.transpose:
        h, wd = x.shape[-2], x.shape[-1]
        y = F.conv_transpose2d(x, w, stride=blk.stride)
        y = y[..., 1:1 + blk.stride * h, 1:1 + blk.stride * wd] + b[:, None, None]
    else:
        px = _shrink_pad(x.shape[-2], blk.stride, blk.kernel)
        py = _shrink_pad(x.shape[-1], blk.stride, blk.kernel)
        xp = F.pad(x, (py[0], py[1], px[0], px[1]), mode="circular")
        y = F.conv2d(xp, w, b, stride=blk.stride)
    if tf32:
        y = _OutputGrad.apply(y)
    y1, y2 = torch.split(y, blk.features, dim=1)
    return torch.maximum(y1, y2)


def encode(sizes: Sizes, params: Sequence[torch.Tensor], x_nhwc: torch.Tensor,
           il: int, tf32: bool) -> List[torch.Tensor]:
    """(B, x, y, C) -> every level's activation, NCHW, the input level first."""
    x = torch.repeat_interleave(x_nhwc.permute(0, 3, 1, 2), 2, dim=1)
    skips = [x]
    for i, blk in enumerate(sizes.encoder):
        x = _conv_block(x, params[2 * i], params[2 * i + 1], blk, tf32)
        if (i + 1) % (il + 1) == 0:
            skips.append(x)
    return skips


def decode(sizes: Sizes, params: Sequence[torch.Tensor], lat: List[torch.Tensor], il: int,
           tf32: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """NCHW latents, input level first -> NCHW (mean, scale) maps before positive_range."""
    x, j = lat[-1], 0
    for i in range(len(lat) - 2, -1, -1):
        for _ in range(il + 1):
            x = _conv_block(x, params[2 * j], params[2 * j + 1], sizes.decoder[j], tf32)
            j += 1
        tx = sizes.levels[i][0]
        rx = x.shape[-2] - tx
        o = rx // 2 + rx % 2
        x = x[..., o:o + tx, o:o + tx]
        if i > 0:
            x = torch.cat([x, lat[i]], dim=1)
    x = _conv_block(x, params[2 * j], params[2 * j + 1], sizes.decoder[j], tf32)
    return x[:, :1], x[:, 1:]


def positive_range(x: torch.Tensor) -> torch.Tensor:
    """exp(x - 1) + EPS below 1, x above."""
    xm1 = x - 1.0
    return torch.where(xm1 < 0, torch.exp(torch.clamp(xm1, -1e10, 10.0)) + EPS, x)


def _trunc_bounds(loc, scale):
    return (0.0 - loc) / scale, (1e10 - loc) / scale


def _trunc_log_z(loc, scale):
    a, b = _trunc_bounds(loc, scale)
    return torch.log(torch.clamp(torch.special.ndtr(b) - torch.special.ndtr(a), min=EPS))


def _normal_lp(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(scale) - _HALF_LOG_2PI


class Out(NamedTuple):
    loss: torch.Tensor
    recon_mean: torch.Tensor    # (B, x, y): the output mean over the S samples (eval)
    recon_sample: torch.Tensor  # (B, x, y): the last sample's draw


def elbo(sizes: Sizes, enc: Sequence[torch.Tensor], dec: Sequence[torch.Tensor],
         stack: torch.Tensor, mask: torch.Tensor, proj: torch.Tensor, project,
         gen: torch.Generator, pnm: torch.Tensor, s: int, il: int, training: bool,
         kl_weight: float = 1.0, tf32: bool = False) -> Out:
    """The ELBO loss of a batch: ``stack`` (B, x, y, C), ``mask`` (B, A'),
    ``proj`` (B, A', P) on the projector's angles; draws from ``gen``;
    ``kl_weight``: the kl anneal times the kl multiplier."""
    dev = stack.device
    b = stack.shape[0]
    skips = encode(sizes, enc, stack / 300.0, il, tf32)
    locs, scales, latents = [], [], []
    for z in skips:
        loc, log_scale = torch.chunk(z, 2, dim=1)
        scale = positive_range(log_scale) + EPS
        locs.append(loc)
        scales.append(scale)
        loc_s, scale_s = loc.repeat(s, 1, 1, 1), scale.repeat(s, 1, 1, 1)
        shape = (s * b,) + tuple(loc_s.shape[2:]) + (loc_s.shape[1],)  # NHWC draw
        eps = torch.randn(shape, generator=gen, device=dev).permute(0, 3, 1, 2)
        latents.append(loc_s + scale_s * eps)
    mean_raw, scale_raw = decode(sizes, dec, latents, il, tf32)
    loc, scale = positive_range(mean_raw)[:, 0], positive_range(scale_raw)[:, 0]  # (S*B, x, y)
    u = EPS + (1.0 - 2.0 * EPS) * torch.rand((s * b, loc.shape[1], loc.shape[2], 1),
                                             generator=gen, device=dev)[..., 0]
    lo, hi = _trunc_bounds(loc, scale)
    fa, fb = torch.special.ndtr(lo), torch.special.ndtr(hi)
    q = torch.clamp(fa + u * (fb - fa), EPS, 1.0 - EPS)
    x = torch.clamp(loc + scale * torch.special.ndtri(q), 0.0, 1e10)
    lp_out = _normal_lp(x, loc, scale) - _trunc_log_z(loc, scale)
    lp_out = torch.where((x >= 0.0) & (x <= 1e10), lp_out, -math.inf)
    lp_self = lp_out.reshape(s, -1).sum(dim=1)
    pm = project(x) * mask.repeat(s, 1)[:, :, None]
    lp_phys = _normal_lp(proj.repeat(s, 1, 1), pm, EPS + torch.sqrt(pm / pnm + EPS))
    loglik = (lp_phys.reshape(s, -1).sum(dim=1) + lp_self).mean()
    kl = sum((0.5 * (scales[i] ** 2 + locs[i] ** 2 - 1.0 - torch.log(scales[i] ** 2))).sum(
        dim=(1, 2, 3)) for i in range(1, len(skips)))
    loss = torch.mean(kl_weight * kl - loglik) / 1e5
    if training:
        mean = x.reshape((s, b) + x.shape[1:]).mean(dim=0)
    else:
        a0, b0 = lo, hi
        phi_a = torch.exp(-0.5 * a0 * a0) * (1.0 / math.sqrt(2.0 * math.pi))
        phi_b = torch.exp(-0.5 * b0 * b0) * (1.0 / math.sqrt(2.0 * math.pi))
        z = torch.clamp(torch.special.ndtr(b0) - torch.special.ndtr(a0), min=EPS)
        mean = (loc + scale * (phi_a - phi_b) / z).reshape((s, b) + x.shape[1:]).mean(dim=0)
    return Out(loss, mean, x.reshape((s, b) + x.shape[1:])[-1])


# ---------------------------------------------------------------- set-up
def make_masks(n: int, num_angles: int, num_sparse: int, random: bool, seed: int) -> np.ndarray:
    """(n, A) masks of ``num_sparse`` angles each (a fresh permutation per
    example from default_rng(seed), or evenly spaced), over num_sparse."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((n, num_angles), np.float32)
    if random:
        for i in range(n):
            masks[i, rng.permutation(num_angles)[:num_sparse]] = 1.0
    else:
        spacing = int(np.ceil(num_angles / num_sparse))
        masks[:, (np.arange(num_sparse) * spacing) % num_angles] = 1.0
    return masks / num_sparse


def measurements(sinos: np.ndarray, masks: np.ndarray, pnm: float, seed: int,
                 device: torch.device) -> torch.Tensor:
    """Poisson(sino x mask x pnm) / pnm of the whole set, drawn on ``device``
    from a generator seeded ``seed``."""
    rate = torch.from_numpy(sinos * masks[:, :, None]).to(device) * pnm
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.poisson(rate, generator=gen) / pnm


def seed_of(seed: int, kind: int, index: int) -> int:
    """The generator seed of (run seed, kind 0 train | 1 eval, index)."""
    return int(np.random.SeedSequence([seed, kind, index]).generate_state(1, np.uint64)[0]) >> 1


class IndexStream:
    """Shuffled batches of arange(n) from default_rng(seed), dropping the remainder."""

    def __init__(self, n: int, batch: int, seed: int):
        self.n, self.batch = n, batch
        self.rng = np.random.default_rng(seed)
        self.order, self.pos = np.arange(n), n

    def next(self) -> np.ndarray:
        if self.pos + self.batch > self.n:
            self.order, self.pos = self.rng.permutation(self.n), 0
        self.pos += self.batch
        return self.order[self.pos - self.batch:self.pos]


def anneal(cfg: Dict, step: int) -> float:
    """pnm_start x factor^min(step, num_iter) in float32, factor =
    (pnm / pnm_start)^(1 / num_iter)."""
    factor = float(np.exp(np.log(cfg["poisson_noise_multiplier"] / cfg["pnm_start"])
                          / max(cfg["num_iter"], 1)))
    power = torch.tensor(factor, dtype=torch.float32) ** torch.tensor(
        float(min(step, cfg["num_iter"])), dtype=torch.float32)
    return float(torch.tensor(np.float32(cfg["pnm_start"])) * power)


def full_geometry(theta: np.ndarray, p: int, device: torch.device, cache: Dict):
    """``init_stack``'s provider of the P x P Joseph matrix, kept in ``cache``."""
    def get(forward: bool) -> JosephMatrix:
        if ("full", forward) not in cache:
            cache["full", forward] = JosephMatrix(theta, p, p, device, forward=forward)
        return cache["full", forward]
    return get


class TrainRecord(NamedTuple):
    losses: List[float]
    grads: List[torch.Tensor]          # the first step's clipped gradient, per leaf
    change: List[torch.Tensor]         # the parameters' change after the steps, per leaf
    stack: torch.Tensor                # the init stack of the steps' rows
    rows: np.ndarray                   # those rows
    masks: np.ndarray
    proj: torch.Tensor                 # their measurements


def train_steps(cfg: Dict, sinos: np.ndarray, theta: np.ndarray, weights: Dict, seed: int,
                steps: int, device: torch.device, tf32: bool = False,
                half_batch: bool = False,
                program_stack: Optional[torch.Tensor] = None) -> TrainRecord:
    """The first ``steps`` training steps of a run with seed ``seed`` from
    ``weights`` (Adam at zero): masks, measurements and the init stack of the
    steps' rows, then each step's loss, gradient and update.  ``tf32``: the
    convolutions read TF32-rounded operands (the control); ``half_batch``:
    each step's loss over the first half of its batch (a planted fault).
    ``program_stack``: the program's init stack of the steps' rows, whose tv
    channel the steps train on in place of this stack's (tv is chaotic in
    float32, so only the program's own arithmetic reproduces it); the
    record keeps this stack whole either way."""
    sizes = model_sizes(cfg)
    n, a, p = sinos.shape
    bsz, s, il, api = cfg["batch_size"], cfg["num_samples"], cfg["intermediate_layers"], min(
        cfg["angles_per_iter"], a)
    masks = make_masks(n, a, cfg["num_sparse_angles"], cfg["random_angles"], seed)
    proj_all = measurements(sinos, masks, cfg["poisson_noise_multiplier"], seed, device)
    bstream, astream = IndexStream(n, bsz, seed + 1), IndexStream(a, api, seed + 2)
    batches = [bstream.next() for _ in range(steps)]
    angles = [astream.next() for _ in range(steps)]
    rows = np.unique(np.concatenate(batches))
    proj_rows = proj_all[torch.as_tensor(rows, device=device)]
    del proj_all
    masks_rows = torch.as_tensor(masks[rows], device=device)
    stack = init_stack(proj_rows, masks_rows, theta, cfg["algorithms"], sizes.x,
                       full_geometry(theta, p, device, {}))
    where = {int(r): i for i, r in enumerate(rows)}
    encoder_input = stack
    if program_stack is not None and "tv" in cfg["algorithms"]:
        c = list(cfg["algorithms"]).index("tv")
        encoder_input = stack.clone()
        encoder_input[..., c] = torch.as_tensor(program_stack, device=device)[..., c]
    params = {k: [t.detach().clone().requires_grad_(True) for t in v] for k, v in weights.items()}
    flat = params["encoder"] + params["decoder"]
    blocks = [blk for blk in sizes.encoder + sizes.decoder for _ in (0, 1)]
    start = [t.detach().clone() for t in flat]
    mu = [torch.zeros_like(t) for t in flat]
    nu = [torch.zeros_like(t) for t in flat]
    losses, first, kl_anneal = [], None, 1.0
    for j in range(steps):
        kl_anneal = float(np.clip(np.float32(kl_anneal) * np.float32(cfg["kl_anneal_factor"]),
                                  0.0, 100.0))
        idx = torch.as_tensor([where[int(r)] for r in batches[j]], device=device)
        if half_batch:
            idx = idx[:len(idx) // 2]
        ang = angles[j]
        jm = JosephMatrix(theta[ang], sizes.x, p, device)
        gen = torch.Generator(device=device).manual_seed(seed_of(seed, 0, j))
        pnm = torch.tensor(anneal(cfg, j), dtype=torch.float32, device=device)
        ai = torch.as_tensor(ang, device=device)
        out = elbo(sizes, params["encoder"], params["decoder"], encoder_input[idx],
                   masks_rows[idx].index_select(1, ai), proj_rows[idx].index_select(1, ai),
                   jm.project, gen, pnm, s, il, True,
                   float(np.float32(kl_anneal)) * cfg["kl_multiplier"], tf32)
        grads = torch.autograd.grad(out.loss, flat)
        losses.append(float(out.loss.detach()))
        bc1 = float(1 - torch.tensor(B1) ** torch.tensor(float(j + 1)))
        bc2 = float(1 - torch.tensor(B2) ** torch.tensor(float(j + 1)))
        clipped = []
        with torch.no_grad():
            for i, (p_, g) in enumerate(zip(flat, grads)):
                g = torch.nan_to_num(g, nan=0.0, posinf=math.inf, neginf=-math.inf)
                name = "weight" if i % 2 == 0 else "bias"
                for leaf in leaves(blocks[i], name, g):
                    norm = torch.sqrt(torch.sum(leaf * leaf))
                    leaf.mul_(torch.where(norm > cfg["norm"], cfg["norm"] / (norm + 1e-30), 1.0))
                clipped.append(g)
                mu[i] = (1 - B1) * g + B1 * mu[i]
                nu[i] = (1 - B2) * (g * g) + B2 * nu[i]
                p_.add_((mu[i] / bc1) / (torch.sqrt(nu[i] / bc2) + cfg["adam_epsilon"])
                        * -cfg["learning_rate"])
        if first is None:
            first = clipped
    split = lambda ts: [h for i, t in enumerate(ts)
                        for h in leaves(blocks[i], "weight" if i % 2 == 0 else "bias", t)]
    change = [p_.detach() - p0 for p_, p0 in zip(flat, start)]
    return TrainRecord(losses, split(first), split(change), stack, rows, masks[rows], proj_rows)


def serve_request(cfg: Dict, sinos: np.ndarray, theta: np.ndarray, weights: Dict, seed: int,
                  passes: int, step: int, device: torch.device, tf32: bool = False,
                  joseph: Optional[Dict[str, JosephMatrix]] = None) -> Dict[str, np.ndarray]:
    """Posterior mean, std and sample maps and the per-batch losses of the
    scans ``sinos`` under ``weights``, as a trained run at step ``step``
    serves them with seed ``seed``: masks and measurements from the seed,
    the init stack, then ``passes`` eval passes over all angles per batch.
    ``joseph``: matrices of this geometry kept between calls."""
    sizes = model_sizes(cfg)
    n, a, p = sinos.shape
    bsz, s, il = cfg["batch_size"], cfg["num_samples"], cfg["intermediate_layers"]
    joseph = {} if joseph is None else joseph
    masks = make_masks(n, a, cfg["num_sparse_angles"], cfg["random_angles"], seed)
    proj = measurements(sinos, masks, cfg["poisson_noise_multiplier"], seed, device)
    mask_t = torch.as_tensor(masks, device=device)
    with torch.no_grad():
        stack = init_stack(proj, mask_t, theta, cfg["algorithms"], sizes.x,
                           full_geometry(theta, p, device, joseph))
        if "recon" not in joseph:
            joseph["recon"] = JosephMatrix(theta, sizes.x, p, device, adjoint=False)
        proj_fn = joseph["recon"].project
        gen = torch.Generator(device=device).manual_seed(seed + 7)
        pnm = torch.tensor(anneal(cfg, step), dtype=torch.float32, device=device)
        nb = -(-n // bsz)
        m1 = np.zeros((n, sizes.x, sizes.x), np.float64)
        m2 = np.zeros_like(m1)
        sample = np.zeros((n, sizes.x, sizes.x), np.float32)
        losses = np.zeros(nb, np.float64)
        for bi in range(nb):
            idx = torch.as_tensor(np.minimum(np.arange(bi * bsz, (bi + 1) * bsz), n - 1),
                                  device=device)
            take = min(bsz, n - bi * bsz)
            lo = []
            for ps in range(passes):
                out = elbo(sizes, weights["encoder"], weights["decoder"], stack[idx], mask_t[idx],
                           proj[idx], proj_fn, gen, pnm, s, il, False,
                           cfg["kl_multiplier"], tf32)
                m = out.recon_mean.double().cpu().numpy()[:take]
                m1[bi * bsz:bi * bsz + take] += m
                m2[bi * bsz:bi * bsz + take] += m * m
                if ps == 0:
                    sample[bi * bsz:bi * bsz + take] = out.recon_sample.cpu().numpy()[:take]
                lo.append(float(out.loss))
            losses[bi] = float(np.mean(lo))
    mean = m1 / passes
    std = np.sqrt(np.maximum(m2 / passes - mean ** 2, 0.0))
    return {"mean": mean, "std": std, "sample": sample, "loss": losses}
