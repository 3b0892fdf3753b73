"""Legacy VQ/SD-era conv nets of diffusionmodules/model.py:218-780 (port of
``pbe_tpu/models/vae_legacy.py``).

The half of the reference's model.py that the PBE path never runs: the
original pixel-space DDPM UNet (``Model``), the small decoders
(``SimpleDecoder``, ``UpsampleDecoder``) and the latent-rescaling family
(``LatentRescaler``, ``MergedRescaleEncoder``, ``MergedRescaleDecoder``,
``Upsampler``, ``Resize``), built on the first stage's blocks
(``models/vae.py``). The timestep-aware residual block (``ResnetBlockT``)
follows model.py:84-143, the temb projection added after conv1.

Attention sits at the levels whose running resolution is in
``attn_resolutions`` (model.py:252-264). ``attn_impl`` is "plain" (the
default) or "flash"; only ``Model`` and ``LatentRescaler`` take it, as in
the JAX package. "flash" at a width the kernels have no head dim for
raises ValueError when the module is built, before any launch. Resizes
pick JAX's pixels (``ops.image.jax_resize``), not torch's.

NCHW modules with the reference state_dict keys; the JAX module's params
load through ``convert.vae_legacy_state_dict_from_flax``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pbe_tpu_torch.models.layers import Conv2d, Linear
from pbe_tpu_torch.models.unet import timestep_embedding
from pbe_tpu_torch.models.vae import AttnBlock, Decoder, Downsample, Encoder, ResnetBlock, Upsample
from pbe_tpu_torch.ops.flash_attention import head_dim_error
from pbe_tpu_torch.ops.image import jax_resize
from pbe_tpu_torch.ops.norms import GroupNorm32


def attn_block(ch: int, attn_impl: str) -> AttnBlock:
    """The single-head AttnBlock at width ``ch``; "flash" only where the
    kernels have the head dim."""
    if attn_impl not in ("plain", "flash"):
        raise ValueError(f"unknown attention impl {attn_impl!r}")
    if attn_impl == "flash" and (err := head_dim_error(ch)):
        raise ValueError(f"attn_impl='flash' at width {ch}: the flash kernels' {err}")
    return AttnBlock(ch, attn_impl)


class ResnetBlockT(nn.Module):
    """model.py:84-143 with temb_channels > 0: temb is projected and added
    after conv1 (no ``temb_proj`` where temb_ch is 0)."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_ch:
            self.temb_proj = Linear(temb_ch, out_ch)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.nin_shortcut = Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.temb_proj(F.silu(temb))[:, :, None, None].to(h.dtype)
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class _Level(nn.Module):
    """One resolution level of ``Model``: res blocks, their attention
    blocks, and an optional ``downsample``/``upsample`` set by the caller."""

    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()

    def forward(self, h: torch.Tensor, temb: torch.Tensor | None, i_block: int,
                skip: torch.Tensor | None = None) -> torch.Tensor:
        if skip is not None:
            h = torch.cat([h, skip], dim=1)
        h = self.block[i_block](h, temb)
        return self.attn[i_block](h) if len(self.attn) else h


class _Mid(nn.Module):
    def __init__(self, ch: int, temb_ch: int, attn_impl: str):
        super().__init__()
        self.block_1 = ResnetBlockT(ch, ch, temb_ch)
        self.attn_1 = attn_block(ch, attn_impl)
        self.block_2 = ResnetBlockT(ch, ch, temb_ch)

    def forward(self, h: torch.Tensor, temb: torch.Tensor | None) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(h, temb)), temb)


class Model(nn.Module):
    """The original pixel-space DDPM UNet (model.py:218-367): VAE-style
    blocks + timestep embedding + skip connections, attention by running
    resolution. forward(x, t=None, context=None), NCHW; context is
    concatenated on channels (model.py:321-323), so ``in_channels``
    counts it."""

    def __init__(self, ch: int, out_ch: int, num_res_blocks: int, resolution: int,
                 in_channels: int, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 attn_resolutions: Sequence[int] = (), use_timestep: bool = True,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "plain"):
        super().__init__()
        self.ch = ch
        self.dtype = dtype
        self.use_timestep = use_timestep
        temb_ch = 4 * ch if use_timestep else 0
        if use_timestep:
            self.temb = nn.Module()
            self.temb.dense = nn.ModuleList([Linear(ch, temb_ch), Linear(temb_ch, temb_ch)])
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1)
        widths = [ch]  # of the skips, in the order the up path pops them
        block_in, curr_res = ch, resolution
        self.down = nn.ModuleList()
        for i_level, mult in enumerate(ch_mult):
            level = _Level()
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlockT(block_in, ch * mult, temb_ch))
                block_in = ch * mult
                if curr_res in attn_resolutions:
                    level.attn.append(attn_block(block_in, attn_impl))
                widths.append(block_in)
            if i_level != len(ch_mult) - 1:
                level.downsample = Downsample(block_in)
                widths.append(block_in)
                curr_res //= 2
            self.down.append(level)
        self.mid = _Mid(block_in, temb_ch, attn_impl)
        up: list[nn.Module] = [None] * len(ch_mult)
        # built from the deepest level up, registered under the level index
        for i_level in reversed(range(len(ch_mult))):
            level = _Level()
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlockT(block_in + widths.pop(), ch * ch_mult[i_level],
                                                temb_ch))
                block_in = ch * ch_mult[i_level]
                if curr_res in attn_resolutions:
                    level.attn.append(attn_block(block_in, attn_impl))
            if i_level != 0:
                level.upsample = Upsample(block_in)
                curr_res *= 2
            up[i_level] = level
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1)

    def forward(self, x: torch.Tensor, t: torch.Tensor | None = None,
                context: torch.Tensor | None = None) -> torch.Tensor:
        dt = self.dtype
        if context is not None:
            x = torch.cat([x, context], dim=1)
        temb = None
        if self.use_timestep:
            if t is None:
                raise ValueError("use_timestep: t is required")
            temb = self.temb.dense[0](timestep_embedding(t, self.ch).to(dt))
            temb = self.temb.dense[1](F.silu(temb))
        hs = [self.conv_in(x.to(dt))]
        for level in self.down:
            for i in range(len(level.block)):
                hs.append(level(hs[-1], temb, i))
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1]))
        h = self.mid(hs[-1], temb)
        for level in reversed(self.up):
            for i in range(len(level.block)):
                h = level(h, temb, i, skip=hs.pop())
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class SimpleDecoder(nn.Module):
    """model.py:583-617: 1x1 -> 3 ResnetBlocks (x2, x4, x2 widths) -> 1x1 ->
    Upsample -> norm/silu/conv_out."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = in_channels
        self.dtype = dtype
        self.model = nn.ModuleList([Conv2d(c, c, 1), ResnetBlock(c, 2 * c),
                                    ResnetBlock(2 * c, 4 * c), ResnetBlock(4 * c, 2 * c),
                                    Conv2d(2 * c, c, 1), Upsample(c)])
        self.norm_out = GroupNorm32(c, eps=1e-6)
        self.conv_out = Conv2d(c, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        for layer in self.model:
            h = layer(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class UpsampleDecoder(nn.Module):
    """model.py:619-664: per level num_res_blocks+1 ResnetBlocks, then an
    Upsample (but after the last), norm/silu/conv_out."""

    def __init__(self, in_channels: int, out_channels: int, ch: int, num_res_blocks: int,
                 resolution: int, ch_mult: Sequence[int] = (2, 2),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        block_in = in_channels
        self.res_blocks = nn.ModuleList()
        self.upsample_blocks = nn.ModuleList()
        for i_level, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, ch * mult))
                block_in = ch * mult
            self.res_blocks.append(nn.ModuleList(blocks))
            if i_level != len(ch_mult) - 1:
                self.upsample_blocks.append(Upsample(block_in))
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = Conv2d(block_in, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        for i, blocks in enumerate(self.res_blocks):
            for blk in blocks:
                h = blk(h)
            if i < len(self.upsample_blocks):
                h = self.upsample_blocks[i](h)
        return self.conv_out(F.silu(self.norm_out(h)))


class LatentRescaler(nn.Module):
    """model.py:667-702: conv_in -> depth ResnetBlocks -> nearest resize by
    ``factor`` (JAX's half-pixel pick) -> AttnBlock -> depth ResnetBlocks ->
    1x1 conv_out."""

    def __init__(self, factor: float, in_channels: int, mid_channels: int, out_channels: int,
                 depth: int = 2, dtype: torch.dtype = torch.float32, attn_impl: str = "plain"):
        super().__init__()
        self.factor = factor
        self.dtype = dtype
        self.conv_in = Conv2d(in_channels, mid_channels, 3, padding=1)
        self.res_block1 = nn.ModuleList([ResnetBlock(mid_channels, mid_channels)
                                         for _ in range(depth)])
        self.attn = attn_block(mid_channels, attn_impl)
        self.res_block2 = nn.ModuleList([ResnetBlock(mid_channels, mid_channels)
                                         for _ in range(depth)])
        self.conv_out = Conv2d(mid_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.to(self.dtype))
        for blk in self.res_block1:
            h = blk(h)
        hh, ww = h.shape[2:]
        # torch F.interpolate's default mode is 'nearest' (model.py:696)
        h = jax_resize(h, (int(round(hh * self.factor)), int(round(ww * self.factor))), "nearest")
        h = self.attn(h)
        for blk in self.res_block2:
            h = blk(h)
        return self.conv_out(h)


class MergedRescaleEncoder(nn.Module):
    """model.py:704-721: Encoder (double_z=False) -> LatentRescaler."""

    def __init__(self, in_channels: int, ch: int, resolution: int, out_ch: int,
                 num_res_blocks: int, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 rescale_factor: float = 1.0, rescale_module_depth: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = ch * ch_mult[-1]
        self.dtype = dtype
        self.encoder = Encoder(ch, tuple(ch_mult), num_res_blocks, mid, in_channels, "plain",
                               double_z=False)
        self.rescaler = LatentRescaler(rescale_factor, mid, mid, out_ch, rescale_module_depth,
                                       dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rescaler(self.encoder(x.to(self.dtype)))


class MergedRescaleDecoder(nn.Module):
    """model.py:723-737: LatentRescaler -> Decoder."""

    def __init__(self, z_channels: int, out_ch: int, resolution: int, num_res_blocks: int,
                 ch: int, ch_mult: Sequence[int] = (1, 2, 4, 8), rescale_factor: float = 1.0,
                 rescale_module_depth: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        tmp = z_channels * ch_mult[-1]
        self.rescaler = LatentRescaler(rescale_factor, z_channels, tmp, tmp,
                                       rescale_module_depth, dtype)
        self.decoder = Decoder(ch, out_ch, tuple(ch_mult), num_res_blocks, tmp, "plain")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.rescaler(x))


class Upsampler(nn.Module):
    """model.py:740-757: LatentRescaler (fractional factor) + an
    all-upsample Decoder; out_size/in_size power-of-two growth."""

    def __init__(self, in_size: int, out_size: int, in_channels: int, out_channels: int,
                 ch_mult: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        if out_size < in_size:
            raise ValueError(f"out_size {out_size} < in_size {in_size}")
        num_blocks = int(math.log2(out_size // in_size)) + 1
        factor_up = 1.0 + (out_size % in_size)
        self.rescaler = LatentRescaler(factor_up, in_channels, 2 * in_channels, in_channels,
                                       dtype=dtype)
        self.decoder = Decoder(in_channels, out_channels, (ch_mult,) * num_blocks, 2,
                               in_channels, "plain")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.rescaler(x))


class Resize(nn.Module):
    """model.py:759-780 (learned=False; the learned branch raises
    NotImplementedError upstream too): ``jax.image.resize`` in ``mode``."""

    def __init__(self, mode: str = "bilinear"):
        super().__init__()
        self.mode = mode

    def forward(self, x: torch.Tensor, scale_factor: float = 1.0) -> torch.Tensor:
        if scale_factor == 1.0:
            return x
        h, w = x.shape[2:]
        return jax_resize(x, (int(h * scale_factor), int(w * scale_factor)), self.mode)
