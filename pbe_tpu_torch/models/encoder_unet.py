"""Encoder-half UNet + noisy-latent classifier (port of
``pbe_tpu/models/encoder_unet.py``; guided-diffusion lineage).

  * ``LegacyAttentionBlock``  == openaimodel.py:392-441 (GroupNorm -> 1x1 qkv
    -> QKV self-attention -> zero 1x1 proj, residual), in both channel
    orders: legacy heads-before-qkv (QKVAttentionLegacy, :462-487) and
    qkv-before-heads (QKVAttention, :490-525). Both scale q AND k by
    ch^-0.25 and take the softmax in fp32.
  * ``AttentionPool2d``       == openaimodel.py:32-59 (CLIP-style attention
    pooling; the query is the prepended mean token).
  * ``EncoderUNetModel``      == openaimodel.py:892-1108: the UNet's down
    path and middle with a pooling head ('adaptive' | 'attention' |
    'spatial' | 'spatial_v2') giving (B, out_channels) logits.
  * ``classifier_loss`` / ``top_k_accuracy`` == the functional core of
    ldm/models/diffusion/classifier.py:107-225 (NoisyLatentImageClassifier):
    q-sample the latent to a uniform t, classify it, cross-entropy and
    acc@k.

NCHW modules with the reference state_dict keys and layouts (the 1x1
projections are ``Conv1d`` weights (O, I, 1)), so a reference checkpoint
loads with ``strict=True``; ``convert.encoder_unet_state_dict_from_flax``
carries the JAX module's params across. The attention here is plain
PyTorch, as the JAX module's is an einsum.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pbe_tpu_torch.models.layers import Conv2d, Linear
from pbe_tpu_torch.models.unet import (Downsample, ResBlock, TimestepSequential, conv3x3,
                                       timestep_embedding)
from pbe_tpu_torch.ops.conv import as_dtype
from pbe_tpu_torch.ops.norms import GroupNorm32
from pbe_tpu_torch.schedules import DiffusionSchedule

POOLS = ("adaptive", "attention", "spatial", "spatial_v2")


class Conv1x1(nn.Conv1d):
    """The reference's ``conv_nd(1, cin, cout, 1)`` over (B, C, T): fp32
    parameters, computed in the input's dtype."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, as_dtype(self.weight, x.dtype), as_dtype(self.bias, x.dtype))


def _zero(module: nn.Module) -> nn.Module:
    for p in module.parameters():
        nn.init.zeros_(p)
    return module


def _qkv_attention(qkv: torch.Tensor, heads: int, legacy_order: bool) -> torch.Tensor:
    """(B, 3*H*ch, T) -> (B, H*ch, T).

    legacy_order: channels laid out per head as [q,k,v] blocks
    (QKVAttentionLegacy, openaimodel.py:470-480); else [q all | k all | v
    all] (QKVAttention, :500-520)."""
    b, width, t = qkv.shape
    ch = width // (3 * heads)
    if legacy_order:
        q, k, v = qkv.reshape(b, heads, 3, ch, t).unbind(2)
    else:
        q, k, v = qkv.reshape(b, 3, heads, ch, t).unbind(1)
    scale = ch ** -0.25  # on q AND k (more stable in low precision)
    s = torch.einsum("bhct,bhcs->bhts", (q * scale).float(), (k * scale).float())
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bhcs->bhct", p, v).reshape(b, heads * ch, t)


class LegacyAttentionBlock(nn.Module):
    """Self-attention block of the guided-diffusion UNet
    (openaimodel.py:392-441), over NCHW."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1,
                 use_new_attention_order: bool = False):
        super().__init__()
        self.heads = num_heads if num_head_channels == -1 else channels // num_head_channels
        self.legacy_order = not use_new_attention_order
        self.norm = GroupNorm32(channels)
        self.qkv = Conv1x1(channels, 3 * channels)
        self.proj_out = _zero(Conv1x1(channels, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        flat = x.reshape(b, c, h * w)
        a = _qkv_attention(self.qkv(self.norm(flat)), self.heads, self.legacy_order)
        return (flat + self.proj_out(a)).reshape(b, c, h, w)


class AttentionPool2d(nn.Module):
    """CLIP-style attention pooling (openaimodel.py:32-59): prepend the
    spatial mean token, add a learned positional embedding, one QKV
    attention pass (new order), return the pooled token."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_head_channels: int,
                 output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.randn(embed_dim, spacial_dim ** 2 + 1) / embed_dim ** 0.5)
        self.qkv_proj = Conv1x1(embed_dim, 3 * embed_dim)
        self.c_proj = Conv1x1(embed_dim, output_dim)
        self.heads = embed_dim // num_head_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        flat = x.reshape(b, c, h * w)
        tok = torch.cat([flat.mean(dim=-1, keepdim=True), flat], dim=-1)
        tok = tok + self.positional_embedding[None].to(tok.dtype)
        a = _qkv_attention(self.qkv_proj(tok), self.heads, legacy_order=False)
        return self.c_proj(a)[:, :, 0]


class EncoderUNetModel(nn.Module):
    """Down-path UNet classifier trunk (openaimodel.py:892-1108):
    forward(x NCHW, t (B,)) -> (B, out_channels) logits."""

    def __init__(self, image_size: int, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int, attention_resolutions: Sequence[int],
                 channel_mult: Sequence[int] = (1, 2, 4, 8), num_heads: int = 1,
                 num_head_channels: int = -1, use_new_attention_order: bool = False,
                 pool: str = "adaptive", dtype: torch.dtype = torch.float32):
        super().__init__()
        if pool not in POOLS:
            raise NotImplementedError(f"Unexpected {pool} pooling")
        mc = model_channels
        emb_dim = 4 * mc
        self.model_channels = mc
        self.pool = pool
        self.dtype = dtype
        self.time_embed = nn.Sequential(Linear(mc, emb_dim), nn.SiLU(), Linear(emb_dim, emb_dim))

        def attn(ch: int) -> LegacyAttentionBlock:
            return LegacyAttentionBlock(ch, num_heads, num_head_channels,
                                        use_new_attention_order)

        self.input_blocks = nn.ModuleList([TimestepSequential([conv3x3(in_channels, mc)])])
        widths = [mc]  # of every block's output, as the spatial pools collect them
        ch, ds = mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers: list[nn.Module] = [ResBlock(ch, mult * mc, emb_dim)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(TimestepSequential(layers))
                widths.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepSequential([Downsample(ch)]))
                widths.append(ch)
                ds *= 2
        self.middle_block = TimestepSequential([ResBlock(ch, ch, emb_dim), attn(ch),
                                                ResBlock(ch, ch, emb_dim)])
        widths.append(ch)
        if pool == "adaptive":
            self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), nn.AdaptiveAvgPool2d((1, 1)),
                                     _zero(Conv2d(ch, out_channels, 1)), nn.Flatten())
        elif pool == "attention":
            if num_head_channels == -1:
                raise ValueError("attention pooling needs num_head_channels")
            self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), AttentionPool2d(
                image_size // ds, ch, num_head_channels, out_channels))
        elif pool == "spatial":
            self.out = nn.Sequential(Linear(sum(widths), 2048), nn.ReLU(),
                                     Linear(2048, out_channels))
        else:
            self.out = nn.Sequential(Linear(sum(widths), 2048), GroupNorm32(2048), nn.SiLU(),
                                     Linear(2048, out_channels))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        emb = self.time_embed(timestep_embedding(t, self.model_channels).to(dt))
        spatial = self.pool.startswith("spatial")
        results = []
        h = x.to(dt)
        for block in self.input_blocks:
            h = block(h, emb, None)
            if spatial:
                results.append(h.float().mean(dim=(2, 3)))
        h = self.middle_block(h, emb, None)
        if not spatial:
            return self.out(h)
        results.append(h.float().mean(dim=(2, 3)))
        return self.out(torch.cat(results, dim=-1).to(dt))


@dataclasses.dataclass
class EncoderUNetConfig:
    """openaimodel.EncoderUNetModel's constructor surface (classifier configs)."""

    image_size: int
    in_channels: int
    model_channels: int
    out_channels: int
    num_res_blocks: int
    attention_resolutions: Sequence[int]
    channel_mult: Sequence[int] = (1, 2, 4, 8)
    num_heads: int = 1
    num_head_channels: int = -1
    use_new_attention_order: bool = False
    pool: str = "adaptive"

    def build(self, dtype: torch.dtype = torch.float32) -> EncoderUNetModel:
        return EncoderUNetModel(
            image_size=self.image_size, in_channels=self.in_channels,
            model_channels=self.model_channels, out_channels=self.out_channels,
            num_res_blocks=self.num_res_blocks,
            attention_resolutions=tuple(self.attention_resolutions),
            channel_mult=tuple(self.channel_mult), num_heads=self.num_heads,
            num_head_channels=self.num_head_channels,
            use_new_attention_order=self.use_new_attention_order, pool=self.pool, dtype=dtype)


# --------------------------------------------------------------------------
# NoisyLatentImageClassifier functional core (classifier.py:107-225)


def classifier_loss(apply_fn: Callable, schedule: DiffusionSchedule, z: torch.Tensor,
                    labels: torch.Tensor, t: torch.Tensor | int | None = None,
                    noise: torch.Tensor | None = None,
                    generator: torch.Generator | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Noise the latent z (NCHW) to timestep t (uniform from ``generator``
    when None, classifier.py:184; an int or a (B,) tensor), classify it,
    per-sample cross-entropy (classifier.py:189). ``noise`` (z's shape,
    fp32) is drawn from ``generator`` when None; JAX's PRNG and torch's
    differ, so a caller that wants JAX's draws passes t and noise.

    Returns (loss (B,), logits (B, K)) in fp32."""
    b, dev = z.shape[0], z.device
    if t is None:
        t = torch.randint(0, schedule.num_timesteps, (b,), generator=generator, device=dev)
    else:
        t = torch.as_tensor(t, device=dev).long().expand(b)
    if noise is None:
        noise = torch.randn(z.shape, generator=generator, device=dev)
    table = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)[t][:, None, None, None]
    x_noisy = (table(schedule.sqrt_alphas_cumprod) * z.float()
               + table(schedule.sqrt_one_minus_alphas_cumprod) * noise.float()).to(z.dtype)
    logits = apply_fn(x_noisy, t).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0], logits


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Mean top-k hit rate (classifier.py:150-155)."""
    top = logits.topk(k, dim=-1).indices
    return (top == labels[:, None]).any(dim=-1).float().mean()
