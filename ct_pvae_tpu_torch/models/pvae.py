"""Hierarchical maxout conv encoder/decoder (port of ``models/pvae.py``).

Counterparts of ``ConvBlock`` (``direct`` impl only), ``Encoder``,
``Decoder``, ``latent_shapes`` and ``build_models`` (pvae.py:194-475), plus
``params_from_flax``, which carries a flax parameter tree over to a torch
``state_dict``.  Public tensors are NHWC like the JAX package's; the convs
run in NCHW for cuDNN.

What the carry-over has to get right:

  * a conv block is a maxout pair: two convs (flax ``Conv_0``/``Conv_1`` or
    ``ConvTranspose_0``/``_1``) run as one conv with 2F output channels,
    whose halves are then max-ed;
  * every forward conv is VALID after a periodic (wrap-around) pad sized by
    ``_shrink_pad``, the stride-1 output head included;
  * flax ``ConvTranspose(padding="SAME")`` does not flip its kernel; torch
    ``conv_transpose2d`` does, so the kernel is flipped on load.  With
    k = 4, s = 2, ``lax.conv_transpose`` pads the dilated input by (2, 2),
    which is the full transposed output cropped by k-1-2 = 1 in front.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

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


class ConvBlock(nn.Module):
    """Dropout-free maxout conv block on NCHW tensors.

    ``weight`` holds both branch kernels: (2F, C, k, k) for a forward conv,
    (C, 2F, k, k) spatially flipped for a transpose conv (torch layouts).
    """

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int = 1,
                 transpose: bool = False):
        super().__init__()
        self.features, self.kernel, self.stride = features, kernel, stride
        self.transpose = transpose
        shape = (in_ch, 2 * features) if transpose else (2 * features, in_ch)
        self.weight = nn.Parameter(torch.zeros(shape + (kernel, kernel)))
        self.bias = nn.Parameter(torch.zeros(2 * features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel, self.stride
        if self.transpose:
            h, w = x.shape[-2], x.shape[-1]
            y = F.conv_transpose2d(x, self.weight, stride=s)
            # the full output is (h-1)s+k; 'SAME' keeps s*h of it from k-1-pad_a,
            # zero-extended at the back where that runs past the end (s > k)
            off = k - 1 - _transpose_pad_front(k, s)
            y = F.pad(y, (0, max(0, off + s * w - y.shape[-1]), 0, max(0, off + s * h - y.shape[-2])))
            y = y[..., off : off + s * h, off : off + s * w] + self.bias[:, None, None]
        else:
            px = _shrink_pad(x.shape[-2], s, k)
            py = _shrink_pad(x.shape[-1], s, k)
            xp = F.pad(x, (py[0], py[1], px[0], px[1]), mode="circular")
            y = F.conv2d(xp, self.weight, self.bias, stride=s)
        y1, y2 = torch.split(y, self.features, dim=1)
        return torch.maximum(y1, y2)


class Encoder(nn.Module):
    """Downsampling stack; returns every level's activation as a latent skip."""

    def __init__(self, in_channels: int, num_blocks: int, feature_maps: Sequence[int],
                 kernel: int, stride: int, intermediate_layers: int,
                 intermediate_kernel: int, feature_maps_multiplier: int = 2):
        super().__init__()
        self.fmm = feature_maps_multiplier
        blocks = []
        ch = in_channels * feature_maps_multiplier
        for i in range(num_blocks):
            for _ in range(intermediate_layers):
                blocks.append(ConvBlock(ch, ch, intermediate_kernel, 1))
            blocks.append(ConvBlock(ch, feature_maps[i], kernel, stride))
            ch = feature_maps[i]
        self.blocks = nn.ModuleList(blocks)
        self.per_level = intermediate_layers + 1

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, H, W, C) -> list of NHWC skips, the input level first."""
        x = torch.repeat_interleave(x.permute(0, 3, 1, 2), self.fmm, dim=1)
        skips = [x]
        for i, block in enumerate(self.blocks):
            x = block(x)
            if (i + 1) % self.per_level == 0:
                skips.append(x)
        return [s.permute(0, 2, 3, 1) for s in skips]


class Decoder(nn.Module):
    """Upsampling stack from hierarchical latent samples to (mean, var) maps."""

    def __init__(self, skip_shapes: Sequence[Tuple[int, int, int]], latent_channels: Sequence[int],
                 final_channels: int, kernel: int, stride: int,
                 intermediate_layers: int, intermediate_kernel: int):
        super().__init__()
        self.skip_shapes = [tuple(s) for s in skip_shapes]
        self.num_levels = len(latent_channels)
        blocks = []
        ch = latent_channels[-1]
        for i in range(self.num_levels - 2, -1, -1):
            target_z = self.skip_shapes[i][2]
            blocks.append(ConvBlock(ch, target_z, kernel, stride, transpose=True))
            for _ in range(intermediate_layers):
                blocks.append(ConvBlock(target_z, target_z, intermediate_kernel, 1))
            ch = target_z + (latent_channels[i] if i > 0 else 0)
        # the stride-1 output head is the last block, as in the flax tree
        blocks.append(ConvBlock(ch, final_channels * 2, kernel, 1))
        self.blocks = nn.ModuleList(blocks)
        self.per_level = intermediate_layers + 1

    def forward(self, latents: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC latents (input level first) -> NHWC (mean, var) maps."""
        lat = [z.permute(0, 3, 1, 2) for z in latents]
        x = lat[-1]
        for j, i in enumerate(range(self.num_levels - 2, -1, -1)):
            for block in self.blocks[j * self.per_level : (j + 1) * self.per_level]:
                x = block(x)
            target_x, target_y, _ = self.skip_shapes[i]
            # centre crop to the skip's spatial dims (reference models.py:181-191)
            rx, ry = x.shape[-2] - target_x, x.shape[-1] - target_y
            ox, oy = rx // 2 + rx % 2, ry // 2 + ry % 2
            x = x[..., ox : ox + target_x, oy : oy + target_y]
            if i > 0:  # the input-level skip is not concatenated (models.py:192-193)
                x = torch.cat([x, lat[i]], dim=1)
        x = self.blocks[-1](x)
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


def build_models(x_size: int, y_size: int, in_channels: int, cfg):
    """(encoder, decoder, skip_shapes) from a Config, in eval mode (the port
    has no dropout or norm layer, so train and eval mode compute the same)."""
    if cfg.compute_dtype != "float32" or (cfg.conv_impl or "direct") != "direct":
        raise NotImplementedError(
            "the port implements the float32 'direct' conv path only "
            f"(got compute_dtype={cfg.compute_dtype!r}, conv_impl={cfg.conv_impl!r})"
        )
    if cfg.norm_type:
        raise NotImplementedError("norm_type='instance' is not ported yet")
    if cfg.dropout_prob > 0:
        raise NotImplementedError("dropout (dropout_prob > 0) is not ported yet")
    fmm = cfg.feature_maps_multiplier
    feats = [f * fmm for f in cfg.feature_map_counts()]
    shapes = latent_shapes(x_size, y_size, in_channels, cfg)
    enc = Encoder(in_channels, cfg.num_blocks, feats, cfg.kernel_size, cfg.stride_encode,
                  cfg.intermediate_layers, cfg.intermediate_kernel, fmm)
    # probabilistic latents carry half the skip channels (the loc half)
    lat_ch = [z if cfg.deterministic else z // 2 for (_, _, z) in shapes]
    dec = Decoder(shapes, lat_ch, 1, cfg.kernel_size, cfg.stride_encode,
                  cfg.intermediate_layers, cfg.intermediate_kernel)
    return enc.eval(), dec.eval(), shapes


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A flax Encoder or Decoder parameter tree -> the matching torch state_dict.

    ``tree`` maps ``ConvBlock_<i>`` to ``{Conv_0, Conv_1}`` (or
    ``ConvTranspose_0/_1``), each with an HWIO ``kernel`` and a ``bias``.
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
        tree[f"ConvBlock_{i}"] = leaves
    return tree


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Fill ``model`` as flax initialises it: every branch kernel glorot-uniform
    over the fans of its HWIO shape (kh * kw * I in, kh * kw * F out), every
    bias zero.  The same distribution as the JAX package, not the same draws."""
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
    model.load_state_dict(params_from_flax(tree))
