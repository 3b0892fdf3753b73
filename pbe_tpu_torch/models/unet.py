"""The Paint-by-Example UNet (port of ``pbe_tpu/models/unet.py``).

SD-v1 epsilon predictor widened to 9 input channels (4 noisy latents + 4
masked-source latents + 1 mask): model_channels=320, channel_mult=(1,2,4,4),
2 res blocks per level, attention at downsample ratios {1,2,4}, 8 heads,
transformer_depth=1, context_dim=768 (configs/v1.yaml:30-46).

Modules carry the reference state_dict names (``input_blocks.1.0.in_layers.2``
...), so ``state_dict_from_flax`` output loads with ``strict=True``. As in the
JAX package, the single-token cross-attention has no to_q/to_k and the
front-block MyResBlock has no skip. Internally NCHW; ``UNetModel.forward``
takes and returns NHWC like the JAX module.

With ``remat`` (configs/v1.yaml's ``use_checkpoint``), every ResBlock and
SpatialTransformer runs under non-reentrant activation checkpointing when
grad is enabled, as the JAX module wraps them in ``nn.remat``: their
activations are recomputed in the backward instead of being kept.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pbe_tpu_torch.models.layers import QuantConv2d, QuantLinear, to_nchw, to_nhwc
from pbe_tpu_torch.ops.attention import multi_head_attention, single_token_attention
from pbe_tpu_torch.ops.image import nearest_upsample_2x
from pbe_tpu_torch.ops.norms import GroupNorm32, LayerNormF32


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding in [cos, sin] order, fp32; t may be fractional."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def conv3x3(cin: int, cout: int, stride: int = 1) -> QuantConv2d:
    # symmetric padding even at stride 2 (torch Conv2d(padding=1) semantics)
    return QuantConv2d(cin, cout, 3, stride=stride, padding=1)


class ResBlock(nn.Module):
    """Timestep-conditioned residual block (use_scale_shift_norm=False)."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm32(in_ch), nn.SiLU(), conv3x3(in_ch, out_ch))
        self.emb_layers = nn.Sequential(nn.SiLU(), QuantLinear(emb_dim, out_ch))
        self.out_layers = nn.Sequential(GroupNorm32(out_ch), nn.SiLU(), nn.Identity(),
                                        conv3x3(out_ch, out_ch))
        self.skip_connection = (QuantConv2d(in_ch, out_ch, 1) if in_ch != out_ch
                                else nn.Identity())

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None].to(h.dtype)
        h = self.out_layers(h)
        return self.skip_connection(x) + h


class MyResBlock(nn.Module):
    """The fork's front-block variant: returns the 4-channel out conv without
    the skip its reference declares (so the skip has no parameters here)."""

    def __init__(self, ch: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm32(ch), nn.SiLU(), conv3x3(ch, ch))
        self.emb_layers = nn.Sequential(nn.SiLU(), QuantLinear(emb_dim, ch))
        self.out_layers = nn.Sequential(GroupNorm32(ch), nn.SiLU(), nn.Identity(),
                                        conv3x3(ch, 4))

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None].to(h.dtype)
        return self.out_layers(h)


class SelfAttention(nn.Module):
    """attn1: multi-head self-attention with linear projections."""

    def __init__(self, dim: int, heads: int, dim_head: int, attn_impl: str):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.attn_impl = attn_impl
        self.to_q = QuantLinear(dim, inner, bias=False)
        self.to_k = QuantLinear(dim, inner, bias=False)
        self.to_v = QuantLinear(dim, inner, bias=False)
        self.to_out = nn.ModuleList([QuantLinear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = multi_head_attention(self.to_q(x), self.to_k(x), self.to_v(x),
                                   self.heads, impl=self.attn_impl)
        return self.to_out[0](out)


class SingleTokenCrossAttention(nn.Module):
    """attn2 with PBE's one-token exemplar context: softmax over one key is 1,
    so the output is to_out(to_v(context)) broadcast over the queries."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.to_v = QuantLinear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([QuantLinear(inner, dim)])

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        if context.shape[1] != 1:
            raise ValueError("PBE cross-attention takes a single context token, got "
                             f"{context.shape[1]}")
        out = self.to_out[0](self.to_v(context.to(x.dtype)))
        return single_token_attention(out, x.shape[1])


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = QuantLinear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate.float()).to(h.dtype)  # exact GELU in fp32


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(),
                                  QuantLinear(dim * 4, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> GEGLU FF, pre-LN residuals."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 attn_impl: str):
        super().__init__()
        self.attn1 = SelfAttention(dim, heads, dim_head, attn_impl)
        self.attn2 = SingleTokenCrossAttention(dim, context_dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.norm1 = LayerNormF32(dim)
        self.norm2 = LayerNormF32(dim)
        self.norm3 = LayerNormF32(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 proj_in -> transformer blocks -> 1x1 proj_out + x."""

    def __init__(self, ch: int, heads: int, dim_head: int, depth: int,
                 context_dim: int, attn_impl: str):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.proj_in = QuantConv2d(ch, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, context_dim, attn_impl)
            for _ in range(depth)
        ])
        self.proj_out = QuantConv2d(inner, ch, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        x_in = x
        x = self.proj_in(self.norm(x))
        inner = x.shape[1]
        x = to_nhwc(x).reshape(b, h * w, inner)
        for block in self.transformer_blocks:
            x = block(x, context)
        x = to_nchw(x.reshape(b, h, w, inner))
        return self.proj_out(x) + x_in


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = conv3x3(ch, ch, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = conv3x3(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample_2x(x))


class TimestepSequential(nn.ModuleList):
    """One input/middle/output block: its layers run in order, ResBlocks
    with the time embedding, SpatialTransformers with the context; with
    ``remat`` and grad enabled, those two under activation checkpointing."""

    def forward(self, h: torch.Tensor, emb: torch.Tensor, context: torch.Tensor,
                remat: bool = False) -> torch.Tensor:
        remat = remat and torch.is_grad_enabled()
        for layer in self:
            if isinstance(layer, (ResBlock, SpatialTransformer)):
                arg = emb if isinstance(layer, ResBlock) else context
                h = (checkpoint(layer, h, arg, use_reentrant=False) if remat
                     else layer(h, arg))
            elif isinstance(layer, MyResBlock):
                h = layer(h, emb)
            else:
                h = layer(h)
        return h


class UNetModel(nn.Module):
    """eps-predictor: (x NHWC (B,H,W,in), t (B,), context (B,1,768)) -> eps NHWC."""

    def __init__(self, in_channels: int = 9, model_channels: int = 320,
                 out_channels: int = 4, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_heads: int = 8,
                 transformer_depth: int = 1, context_dim: int = 768,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "plain",
                 add_conv_in_front_of_unet: bool = False,
                 num_classes: int | None = None, remat: bool = False):
        super().__init__()
        mc = model_channels
        emb_dim = mc * 4
        self.model_channels = mc
        self.dtype = dtype
        self.remat = remat
        self.num_classes = num_classes
        self.time_embed = nn.Sequential(QuantLinear(mc, emb_dim), nn.SiLU(),
                                        QuantLinear(emb_dim, emb_dim))
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, emb_dim)
        self.add_conv_in_front_of_unet = add_conv_in_front_of_unet
        if add_conv_in_front_of_unet:
            # the fork's front block: 9-channel input -> conv -> MyResBlock
            # compressing to the 4-channel trunk input ('add_resbolck' sic)
            self.add_resbolck = nn.ModuleList([
                TimestepSequential([conv3x3(9, mc)]),
                TimestepSequential([MyResBlock(mc, emb_dim)]),
            ])

        def tf(ch: int) -> SpatialTransformer:
            return SpatialTransformer(ch, num_heads, ch // num_heads, transformer_depth,
                                      context_dim, attn_impl)

        self.input_blocks = nn.ModuleList([TimestepSequential([conv3x3(in_channels, mc)])])
        chans = [mc]
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers: list[nn.Module] = [ResBlock(ch, mult * mc, emb_dim)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(tf(ch))
                self.input_blocks.append(TimestepSequential(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepSequential([Downsample(ch)]))
                chans.append(ch)
                ds *= 2

        self.middle_block = TimestepSequential([
            ResBlock(ch, ch, emb_dim), tf(ch), ResBlock(ch, ch, emb_dim),
        ])

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + chans.pop(), mc * mult, emb_dim)]
                ch = mc * mult
                if ds in attention_resolutions:
                    layers.append(tf(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(TimestepSequential(layers))

        self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), conv3x3(ch, out_channels))

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                y: torch.Tensor | None = None) -> torch.Tensor:
        dt = self.dtype
        emb = self.time_embed(timestep_embedding(t, self.model_channels).to(dt))
        if self.num_classes is not None:
            if y is None:
                raise ValueError("num_classes set but no y labels given")
            emb = emb + self.label_emb(y).to(emb.dtype)
        context = context.to(dt)
        h = to_nchw(x).to(dt)
        if self.add_conv_in_front_of_unet:
            for block in self.add_resbolck:
                h = block(h, emb, context)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, context, self.remat)
            hs.append(h)
        h = self.middle_block(h, emb, context, self.remat)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, context, self.remat)
        return to_nhwc(self.out(h)).to(x.dtype)


@dataclasses.dataclass
class UNetConfig:
    """configs/v1.yaml unet_config-compatible constructor."""

    image_size: int = 32  # unused, kept for config parity (v1.yaml:33)
    in_channels: int = 9
    out_channels: int = 4
    model_channels: int = 320
    attention_resolutions: Sequence[int] = (4, 2, 1)
    num_res_blocks: int = 2
    channel_mult: Sequence[int] = (1, 2, 4, 4)
    num_heads: int = 8
    use_spatial_transformer: bool = True
    transformer_depth: int = 1
    context_dim: int = 768
    use_checkpoint: bool = True  # remat when build() is given remat=None
    legacy: bool = False
    add_conv_in_front_of_unet: bool = False
    num_classes: int | None = None

    def build(self, dtype: torch.dtype = torch.float32, attn_impl: str = "plain",
              remat: bool | None = None) -> UNetModel:
        return UNetModel(
            in_channels=self.in_channels, model_channels=self.model_channels,
            out_channels=self.out_channels, num_res_blocks=self.num_res_blocks,
            attention_resolutions=tuple(self.attention_resolutions),
            channel_mult=tuple(self.channel_mult), num_heads=self.num_heads,
            transformer_depth=self.transformer_depth, context_dim=self.context_dim,
            dtype=dtype, attn_impl=attn_impl,
            add_conv_in_front_of_unet=self.add_conv_in_front_of_unet,
            num_classes=self.num_classes,
            remat=self.use_checkpoint if remat is None else remat,
        )
