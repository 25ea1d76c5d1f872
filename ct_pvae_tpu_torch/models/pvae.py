"""Hierarchical maxout conv encoder/decoder (port of ``models/pvae.py``).

Counterparts of ``ConvBlock``, ``InstanceNorm``, ``Encoder``, ``Decoder``,
``latent_shapes`` and ``build_models`` (pvae.py:137-475), plus
``params_from_flax``, which carries a flax parameter tree over to a torch
``state_dict``.  Public tensors are NHWC like the JAX package's; the convs
run in NCHW for cuDNN.

What the carry-over has to get right:

  * a conv block is dropout, then a maxout pair: two convs (flax
    ``Conv_0``/``Conv_1`` or ``ConvTranspose_0``/``_1``) run as one conv with
    2F output channels, whose halves are then max-ed, then an optional
    InstanceNorm (flax ``InstanceNorm_0``: ``scale``, ``offset``);
  * every forward conv is VALID after a periodic (wrap-around) pad sized by
    ``_shrink_pad``, the stride-1 output head included;
  * flax ``ConvTranspose(padding="SAME")`` does not flip its kernel; torch
    ``conv_transpose2d`` does, so the kernel is flipped on load.  With
    k = 4, s = 2, ``lax.conv_transpose`` pads the dilated input by (2, 2),
    which is the full transposed output cropped by k-1-2 = 1 in front.

``conv_impl`` picks how a conv is computed, never what: ``direct`` (cuDNN),
``subpixel`` (a strided conv as space-to-depth plus a stride-1 conv, a
strided transpose conv as one stride-1 conv over its phases plus a pixel
shuffle, pvae.py:53-135) or ``im2col`` (the forward convs as patches times
one matrix, pvae.py:160-192); plain torch, as they are XLA code there.
``compute_dtype: bfloat16`` stores the activations in bfloat16, as the JAX
package's ``dtype``: each block rounds its input, kernel and bias to
bfloat16, sums their exact products in float32 (the TPU's one-pass MXU
products) and rounds its output where XLA does; the parameters, InstanceNorm,
the output head and the interface stay in float32.  Dropout masks come from the
caller's draw source (``keep``), so they follow the step's generator.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _shrink_pad(size: int, stride: int, kernel: int) -> Tuple[int, int]:
    """Padding so a VALID conv maps ``size -> ceil(size/stride)`` exactly
    (reference models.py:305-324: larger half in front)."""
    rem = size % stride
    pad = kernel - rem if rem else kernel - stride
    return (pad // 2 + pad % 2, pad // 2)


def _transpose_pad_front(kernel: int, stride: int) -> int:
    """Front padding ``lax.conv_transpose(..., 'SAME')`` gives the dilated input."""
    pad_len = kernel + stride - 2
    return kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)


def _transpose_phase_taps(k: int, s: int):
    """Taps (p, d, q) of ``lax.conv_transpose(..., 'SAME')``'s phase form
    (pvae.py:71-93): output row s*h + p reads input row h + d against kernel
    row q; with the range (d_lo, d_hi) of d."""
    pad_a = _transpose_pad_front(k, s)
    taps = [(p, d, pad_a - p + s * d) for p in range(s) for d in range(-k, k + 1)
            if 0 <= pad_a - p + s * d < k]
    return taps, min(t[1] for t in taps), max(t[1] for t in taps)


KeepFn = Callable[[Tuple[int, ...], float], torch.Tensor]


class ConvBlock(nn.Module):
    """Maxout conv block on NCHW tensors: dropout, the conv pair, InstanceNorm.

    ``weight`` holds both branch kernels: (2F, C, k, k) for a forward conv,
    (C, 2F, k, k) spatially flipped for a transpose conv (torch layouts).
    """

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int = 1,
                 transpose: bool = False, dropout: float = 0.0, norm: Optional[str] = None,
                 impl: str = "direct", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.features, self.kernel, self.stride = features, kernel, stride
        self.transpose, self.dropout, self.norm, self.impl, self.dtype = (
            transpose, dropout, norm, impl, dtype)
        shape = (in_ch, 2 * features) if transpose else (2 * features, in_ch)
        self.weight = nn.Parameter(torch.zeros(shape + (kernel, kernel)))
        self.bias = nn.Parameter(torch.zeros(2 * features))
        if norm == "instance":
            self.norm_scale = nn.Parameter(torch.ones(features))
            self.norm_offset = nn.Parameter(torch.zeros(features))
        elif norm is not None:
            raise ValueError(f"unknown norm {norm!r} (use None or 'instance')")
        self.subpixel = impl == "subpixel" and stride > 1 and (transpose or kernel % stride == 0)
        if self.subpixel and transpose:
            # which kernel tap (qh * k + qw, or k * k: zero) each phase's
            # stride-1 kernel holds at each of its (wd, wd) taps
            taps, d_lo, d_hi = _transpose_phase_taps(kernel, stride)
            wd = d_hi - d_lo + 1
            index = np.full((stride * stride, wd, wd), kernel * kernel, np.int64)
            for p, dh, qh in taps:
                for q, dw, qw in taps:
                    index[p * stride + q, dh - d_lo, dw - d_lo] = qh * kernel + qw
            self.register_buffer("phase_taps", torch.from_numpy(index), persistent=False)
            self.phase_range = (d_lo, d_hi)

    def _conv_transpose_subpixel(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The stride-s 'SAME' transpose conv as one stride-1 conv over its s^2
        phases and a pixel shuffle (``_subpixel_conv_transpose``)."""
        k, s = self.kernel, self.stride
        b, c, h, wid = x.shape
        f2 = w.shape[1]
        d_lo, d_hi = self.phase_range
        wd = d_hi - d_lo + 1
        # HWIO taps (the stored kernel is flipped), then a zero tap
        taps = torch.cat([w.flip(-2, -1).permute(2, 3, 1, 0).reshape(k * k, f2, c),
                          w.new_zeros((1, f2, c))])
        k2 = taps[self.phase_taps.reshape(-1)].reshape(s * s, wd, wd, f2, c)
        k2 = k2.permute(0, 3, 4, 1, 2).reshape(s * s * f2, c, wd, wd)
        start, lpad = max(d_lo, 0), max(0, -d_lo)
        xx = F.pad(x[..., start:, start:], (lpad, d_hi, lpad, d_hi))
        y = F.conv2d(xx, k2)
        return y.reshape(b, s, s, f2, h, wid).permute(0, 3, 4, 1, 5, 2).reshape(b, f2, h * s, wid * s)

    def forward(self, x: torch.Tensor, keep: Optional[KeepFn] = None) -> torch.Tensor:
        k, s = self.kernel, self.stride
        if self.dropout > 0 and keep is not None:  # flax Dropout: keep / (1 - p), else 0
            x = torch.where(keep(tuple(x.shape), self.dropout), x / (1.0 - self.dropout), 0.0)
        # the storage dtype: the input, kernel and bias are rounded to it and
        # the conv sums their exact products in float32, as the TPU's MXU
        # does; the output is rounded once, after the bias (forward convs) or
        # before it (transposed convs, whose bias then adds in the storage
        # dtype), where the JAX package's XLA rounds.  No-ops in float32.
        lo = self.dtype
        x = x.to(lo).float()
        weight, bias = self.weight.to(lo).float(), self.bias.to(lo).float()
        if self.transpose:
            h, w = x.shape[-2], x.shape[-1]
            if self.subpixel:
                y = self._conv_transpose_subpixel(x, weight)
            else:
                y = F.conv_transpose2d(x, weight, stride=s)
                # the full output is (h-1)s+k; 'SAME' keeps s*h of it from k-1-pad_a,
                # zero-extended at the back where that runs past the end (s > k)
                off = k - 1 - _transpose_pad_front(k, s)
                y = F.pad(y, (0, max(0, off + s * w - y.shape[-1]),
                              0, max(0, off + s * h - y.shape[-2])))
                y = y[..., off : off + s * h, off : off + s * w]
            y = y.to(lo) + bias.to(lo)[:, None, None]
        else:
            px = _shrink_pad(x.shape[-2], s, k)
            py = _shrink_pad(x.shape[-1], s, k)
            xp = F.pad(x, (py[0], py[1], px[0], px[1]), mode="circular")
            if self.subpixel:  # space-to-depth, then a stride-1 conv (``_subpixel_strided``)
                b, c, hp, wp = xp.shape
                m = k // s
                z = xp.reshape(b, c, hp // s, s, wp // s, s).permute(0, 3, 5, 1, 2, 4)
                k2 = weight.reshape(-1, c, m, s, m, s).permute(0, 3, 5, 1, 2, 4)
                y = F.conv2d(z.reshape(b, s * s * c, hp // s, wp // s),
                             k2.reshape(-1, s * s * c, m, m), bias)
            elif self.impl == "im2col":  # patches times one matrix (``_im2col_conv``)
                b = xp.shape[0]
                ho, wo = (xp.shape[-2] - k) // s + 1, (xp.shape[-1] - k) // s + 1
                cols = F.unfold(xp, k, stride=s)  # (B, C k k, H' W'), (c, dy, dx) order
                y = torch.matmul(weight.reshape(weight.shape[0], -1), cols)
                y = y.reshape(b, -1, ho, wo) + bias[:, None, None]
            else:
                y = F.conv2d(xp, weight, bias, stride=s)
            y = y.to(lo)
        y1, y2 = torch.split(y, self.features, dim=1)
        out = torch.maximum(y1, y2)
        if self.norm == "instance":  # InstanceNorm (pvae.py:137-157) in float32
            xf = out.float()
            mean = xf.mean(dim=(2, 3), keepdim=True)
            var = xf.var(dim=(2, 3), unbiased=False, keepdim=True)
            xf = (xf - mean) * torch.rsqrt(var + 1e-5) * self.norm_scale[:, None, None] \
                + self.norm_offset[:, None, None]
            out = xf.to(out.dtype)
        return out


class Encoder(nn.Module):
    """Downsampling stack; returns every level's activation as a latent skip."""

    def __init__(self, in_channels: int, num_blocks: int, feature_maps: Sequence[int],
                 kernel: int, stride: int, intermediate_layers: int,
                 intermediate_kernel: int, feature_maps_multiplier: int = 2, **block_kw):
        super().__init__()
        self.fmm = feature_maps_multiplier
        blocks = []
        ch = in_channels * feature_maps_multiplier
        for i in range(num_blocks):
            for _ in range(intermediate_layers):
                blocks.append(ConvBlock(ch, ch, intermediate_kernel, 1, **block_kw))
            blocks.append(ConvBlock(ch, feature_maps[i], kernel, stride, **block_kw))
            ch = feature_maps[i]
        self.blocks = nn.ModuleList(blocks)
        self.per_level = intermediate_layers + 1

    def forward(self, x: torch.Tensor, keep: Optional[KeepFn] = None) -> List[torch.Tensor]:
        """(B, H, W, C) -> list of float32 NHWC skips, the input level first."""
        x = torch.repeat_interleave(x.permute(0, 3, 1, 2), self.fmm, dim=1)
        skips = [x]
        for i, block in enumerate(self.blocks):
            x = block(x, keep)
            if (i + 1) % self.per_level == 0:
                skips.append(x)
        return [s.permute(0, 2, 3, 1).float() for s in skips]


class Decoder(nn.Module):
    """Upsampling stack from hierarchical latent samples to (mean, var) maps."""

    def __init__(self, skip_shapes: Sequence[Tuple[int, int, int]], latent_channels: Sequence[int],
                 final_channels: int, kernel: int, stride: int,
                 intermediate_layers: int, intermediate_kernel: int, dropout: float = 0.0,
                 **block_kw):
        super().__init__()
        self.skip_shapes = [tuple(s) for s in skip_shapes]
        self.num_levels = len(latent_channels)
        blocks = []
        ch = latent_channels[-1]
        kw = dict(block_kw, dropout=dropout)
        for i in range(self.num_levels - 2, -1, -1):
            target_z = self.skip_shapes[i][2]
            blocks.append(ConvBlock(ch, target_z, kernel, stride, transpose=True, **kw))
            for _ in range(intermediate_layers):
                blocks.append(ConvBlock(target_z, target_z, intermediate_kernel, 1, **kw))
            ch = target_z + (latent_channels[i] if i > 0 else 0)
        # the stride-1 output head is the last block, as in the flax tree: in
        # float32 and without a norm, whatever the other blocks use
        blocks.append(ConvBlock(ch, final_channels * 2, kernel, 1, dropout=dropout))
        self.blocks = nn.ModuleList(blocks)
        self.per_level = intermediate_layers + 1

    def forward(self, latents: Sequence[torch.Tensor],
                keep: Optional[KeepFn] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC latents (input level first) -> NHWC float32 (mean, var) maps."""
        lat = [z.permute(0, 3, 1, 2) for z in latents]
        x = lat[-1]
        for j, i in enumerate(range(self.num_levels - 2, -1, -1)):
            for block in self.blocks[j * self.per_level : (j + 1) * self.per_level]:
                x = block(x, keep)
            target_x, target_y, _ = self.skip_shapes[i]
            # centre crop to the skip's spatial dims (reference models.py:181-191)
            rx, ry = x.shape[-2] - target_x, x.shape[-1] - target_y
            ox, oy = rx // 2 + rx % 2, ry // 2 + ry % 2
            x = x[..., ox : ox + target_x, oy : oy + target_y]
            if i > 0:  # the input-level skip is not concatenated (models.py:192-193)
                x = torch.cat([x.float(), lat[i]], dim=1)  # bfloat16 beside float32: float32
        x = self.blocks[-1](x.float(), keep)
        mean, var = torch.split(x, x.shape[1] // 2, dim=1)
        return mean.permute(0, 2, 3, 1), var.permute(0, 2, 3, 1)


def latent_shapes(x_size: int, y_size: int, in_channels: int, cfg) -> List[Tuple[int, int, int]]:
    """Static skip shapes (x, y, z) per level, z including the fmm factor."""
    fmm = cfg.feature_maps_multiplier
    shapes = [(x_size, y_size, in_channels * fmm)]
    sx, sy = x_size, y_size
    for f in cfg.feature_map_counts():
        sx = -(-sx // cfg.stride_encode)
        sy = -(-sy // cfg.stride_encode)
        shapes.append((sx, sy, f * fmm))
    return shapes


CONV_IMPLS = ("direct", "subpixel", "im2col")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_models(x_size: int, y_size: int, in_channels: int, cfg):
    """(encoder, decoder, skip_shapes) from a Config, in eval mode (dropout
    follows the ``keep`` source the step hands the models, not the mode)."""
    impl = cfg.conv_impl or "direct"
    if impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl={cfg.conv_impl!r}: use one of {CONV_IMPLS}")
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: use one of {tuple(COMPUTE_DTYPES)}")
    block_kw = dict(norm=cfg.norm_type or None, impl=impl, dtype=COMPUTE_DTYPES[cfg.compute_dtype])
    fmm = cfg.feature_maps_multiplier
    feats = [f * fmm for f in cfg.feature_map_counts()]
    shapes = latent_shapes(x_size, y_size, in_channels, cfg)
    enc = Encoder(in_channels, cfg.num_blocks, feats, cfg.kernel_size, cfg.stride_encode,
                  cfg.intermediate_layers, cfg.intermediate_kernel, fmm,
                  dropout=cfg.dropout_prob, **block_kw)
    # probabilistic latents carry half the skip channels (the loc half)
    lat_ch = [z if cfg.deterministic else z // 2 for (_, _, z) in shapes]
    dec = Decoder(shapes, lat_ch, 1, cfg.kernel_size, cfg.stride_encode,
                  cfg.intermediate_layers, cfg.intermediate_kernel, cfg.dropout_prob, **block_kw)
    return enc.eval(), dec.eval(), shapes


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax Encoder or Decoder parameter tree -> the matching torch state_dict.

    ``tree`` maps ``ConvBlock_<i>`` to ``{Conv_0, Conv_1}`` (or
    ``ConvTranspose_0/_1``), each with an HWIO ``kernel`` and a ``bias``, and
    to ``InstanceNorm_0`` (``scale``, ``offset``) where the block has a norm.
    Block i becomes ``blocks.<i>`` (the decoder's output head is its last).
    """
    names = sorted(tree, key=lambda k: int(k.rsplit("_", 1)[1]))
    if names != [f"ConvBlock_{i}" for i in range(len(names))]:
        raise ValueError(f"unexpected flax block names: {names}")
    out: Dict[str, torch.Tensor] = {}
    for i, name in enumerate(names):
        blk = tree[name]
        transpose = "ConvTranspose_0" in blk
        base = "ConvTranspose" if transpose else "Conv"
        kern = np.concatenate(
            [np.asarray(blk[f"{base}_0"]["kernel"]), np.asarray(blk[f"{base}_1"]["kernel"])], axis=-1
        )  # (kh, kw, I, 2F)
        bias = np.concatenate([np.asarray(blk[f"{base}_0"]["bias"]), np.asarray(blk[f"{base}_1"]["bias"])])
        if transpose:
            # flax correlates the dilated input with the kernel as stored;
            # torch's conv_transpose2d flips it: store it flipped, as (I, O, kh, kw)
            w = np.ascontiguousarray(kern[::-1, ::-1].transpose(2, 3, 0, 1))
        else:
            w = np.ascontiguousarray(kern.transpose(3, 2, 0, 1))  # (O, I, kh, kw)
        out[f"blocks.{i}.weight"] = torch.from_numpy(w.astype(np.float32))
        out[f"blocks.{i}.bias"] = torch.from_numpy(bias.astype(np.float32))
        if "InstanceNorm_0" in blk:
            for leaf, key in (("scale", "norm_scale"), ("offset", "norm_offset")):
                out[f"blocks.{i}.{key}"] = torch.from_numpy(
                    np.asarray(blk["InstanceNorm_0"][leaf], np.float32).copy())
    return out


def _branch_names(block: ConvBlock) -> Tuple[str, str]:
    base = "ConvTranspose" if block.transpose else "Conv"
    return f"{base}_0", f"{base}_1"


def branch_halves(block: ConvBlock, name: str, tensor: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Views of ``tensor`` (a block's ``weight`` or ``bias``, or a tensor of
    that shape) split into the two maxout branches, the flax leaves
    ``Conv_0``/``Conv_1`` (``ConvTranspose_0``/``_1``)."""
    dim = 1 if name == "weight" and block.transpose else 0
    return torch.split(tensor, block.features, dim=dim)


def flax_leaves(block: ConvBlock, name: str, tensor: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Views of ``tensor`` (a block parameter ``name``, or a tensor of its
    shape) as flax leaves: the two maxout branches of ``weight`` and
    ``bias``; an InstanceNorm ``norm_scale`` or ``norm_offset`` is one leaf."""
    return branch_halves(block, name, tensor) if name in ("weight", "bias") else (tensor,)


def params_to_flax(model: nn.Module, tensors: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
    """The inverse of ``params_from_flax``: ``model``'s ``state_dict`` (or
    ``tensors`` keyed the same way, such as Adam moments) as a flax tree of
    float32 numpy arrays, the maxout branches split and the transpose-conv
    kernels un-flipped to flax's HWIO layout."""
    tensors = model.state_dict() if tensors is None else tensors
    tree: Dict[str, Dict] = {}
    for i, block in enumerate(model.blocks):
        leaves = {}
        halves_w = branch_halves(block, "weight", tensors[f"blocks.{i}.weight"].detach().cpu())
        halves_b = branch_halves(block, "bias", tensors[f"blocks.{i}.bias"].detach().cpu())
        for branch, w, b in zip(_branch_names(block), halves_w, halves_b):
            w = w.numpy()
            if block.transpose:
                kern = w.transpose(2, 3, 0, 1)[::-1, ::-1]  # (I, F, kh, kw) flipped -> HWIO
            else:
                kern = w.transpose(2, 3, 1, 0)              # (F, I, kh, kw) -> HWIO
            leaves[branch] = {"bias": np.ascontiguousarray(b.numpy(), np.float32),
                              "kernel": np.ascontiguousarray(kern, np.float32)}
        if block.norm:
            leaves["InstanceNorm_0"] = {
                leaf: np.ascontiguousarray(tensors[f"blocks.{i}.{key}"].detach().cpu().numpy(),
                                           np.float32)
                for leaf, key in (("offset", "norm_offset"), ("scale", "norm_scale"))}
        tree[f"ConvBlock_{i}"] = leaves
    return tree


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Fill ``model`` as flax initialises it: every branch kernel glorot-uniform
    over the fans of its HWIO shape (kh * kw * I in, kh * kw * F out), every
    bias zero, InstanceNorm scales one and offsets zero.  The same
    distribution as the JAX package, not the same draws."""
    tree = {}
    for i, block in enumerate(model.blocks):
        w = block.weight
        in_ch = w.shape[0] if block.transpose else w.shape[1]
        k, f = block.kernel, block.features
        limit = float(np.sqrt(6.0 / (k * k * in_ch + k * k * f)))
        tree[f"ConvBlock_{i}"] = {
            branch: {
                "kernel": ((torch.rand((k, k, in_ch, f), generator=generator) * 2 - 1) * limit).numpy(),
                "bias": np.zeros(f, np.float32),
            }
            for branch in _branch_names(block)
        }
        if block.norm:
            tree[f"ConvBlock_{i}"]["InstanceNorm_0"] = {"scale": np.ones(f, np.float32),
                                                        "offset": np.zeros(f, np.float32)}
    model.load_state_dict(params_from_flax(tree))
