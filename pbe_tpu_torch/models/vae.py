"""KL autoencoder, the Stable-Diffusion first stage (port of
``pbe_tpu/models/vae.py``): ch=128, ch_mult=(1,2,4,4), 2 res blocks, no
down-path attention, one single-head attention in each mid block,
z_channels=4 (configs/v1.yaml:48-69).

Padding: 3x3 convs pad 1 and 1x1 convs pad 0 (flax "SAME" at stride 1);
Downsample pads (0,1,0,1) before a stride-2 valid conv. GroupNorm eps 1e-6.
``encode``/``decode`` take and return NHWC; the blocks are NCHW.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pbe_tpu_torch.models.layers import Conv2d, to_nchw, to_nhwc
from pbe_tpu_torch.ops.attention import multi_head_attention
from pbe_tpu_torch.ops.image import nearest_upsample_2x
from pbe_tpu_torch.ops.norms import GroupNorm32


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.nin_shortcut = Conv2d(in_ch, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over all spatial positions."""

    def __init__(self, ch: int, attn_impl: str):
        super().__init__()
        self.attn_impl = attn_impl
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.q = Conv2d(ch, ch, 1)
        self.k = Conv2d(ch, ch, 1)
        self.v = Conv2d(ch, ch, 1)
        self.proj_out = Conv2d(ch, ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hn = self.norm(x)
        # contiguous: at batch 1 the reshape would be a channel-strided view,
        # and the flash kernel takes a unit head-dim stride
        tokens = lambda t: to_nhwc(t).reshape(b, h * w, c).contiguous()
        out = multi_head_attention(tokens(self.q(hn)), tokens(self.k(hn)),
                                   tokens(self.v(hn)), num_heads=1, impl=self.attn_impl)
        return x + self.proj_out(to_nchw(out.reshape(b, h, w, c)))


class Downsample(nn.Module):
    """Stride-2 conv after the reference's asymmetric (0,1,0,1) padding."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_upsample_2x(x))


class Mid(nn.Module):
    def __init__(self, ch: int, attn_impl: str):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch)
        self.attn_1 = AttnBlock(ch, attn_impl)
        self.block_2 = ResnetBlock(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(x)))


class Level(nn.Module):
    """One resolution level: res blocks, then an optional resample."""

    def __init__(self, blocks: list[nn.Module], resample: str | None, ch: int):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample == "down":
            self.downsample = Downsample(ch)
        elif resample == "up":
            self.upsample = Upsample(ch)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for blk in self.block:
            h = blk(h)
        if hasattr(self, "downsample"):
            h = self.downsample(h)
        if hasattr(self, "upsample"):
            h = self.upsample(h)
        return h


class Encoder(nn.Module):
    def __init__(self, ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, in_channels: int, attn_impl: str):
        super().__init__()
        self.conv_in = Conv2d(in_channels, ch, 3, padding=1)
        levels = []
        block_in = ch
        for i, mult in enumerate(ch_mult):
            blocks = []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(block_in, ch * mult))
                block_in = ch * mult
            levels.append(Level(blocks, "down" if i != len(ch_mult) - 1 else None, block_in))
        self.down = nn.ModuleList(levels)
        self.mid = Mid(block_in, attn_impl)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = Conv2d(block_in, 2 * z_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch: int, out_ch: int, ch_mult: Sequence[int], num_res_blocks: int,
                 z_channels: int, attn_impl: str):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = Mid(block_in, attn_impl)
        levels: list[nn.Module] = []
        # built from the deepest level up, registered under the level index
        for i in reversed(range(len(ch_mult))):
            blocks = []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, ch * ch_mult[i]))
                block_in = ch * ch_mult[i]
            levels.insert(0, Level(blocks, "up" if i != 0 else None, block_in))
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = Conv2d(block_in, out_ch, 3, padding=1)

    def features(self, z: torch.Tensor) -> torch.Tensor:
        """Everything up to conv_out: the input of the last layer, which
        the adaptive GAN weight differentiates (training/vae_train.py)."""
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level(h)
        return F.silu(self.norm_out(h))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.features(z))


class AutoencoderKL(nn.Module):
    def __init__(self, ch: int = 128, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, embed_dim: int = 4,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "plain"):
        super().__init__()
        self.dtype = dtype
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, z_channels, in_channels,
                               attn_impl)
        self.decoder = Decoder(ch, out_ch, ch_mult, num_res_blocks, z_channels, attn_impl)
        self.quant_conv = Conv2d(2 * z_channels, 2 * embed_dim, 1)
        self.post_quant_conv = Conv2d(embed_dim, z_channels, 1)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x NHWC in [-1,1] -> (mean, logvar) NHWC; logvar clamped to [-30, 20]."""
        moments = self.quant_conv(self.encoder(to_nchw(x).to(self.dtype)))
        mean, logvar = to_nhwc(moments).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z NHWC latent -> NHWC image."""
        return to_nhwc(self.decoder(self.post_quant_conv(to_nchw(z).to(self.dtype))))

    def latent_shape(self, image_shape: Sequence[int]) -> tuple[int, int, int, int]:
        """(N, H, W, C) image -> the (N, h, w, embed_dim) shape of its latent."""
        n, h, w, _ = image_shape
        f = 2 ** (len(self.encoder.down) - 1)
        return n, h // f, w // f, self.post_quant_conv.in_channels

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None, sample: bool = True,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
        """x NHWC -> (reconstruction NHWC, (mean, logvar)): decode of
        z = mean + std * eps where ``sample`` (eps: ``noise`` of the
        latent's shape, or drawn from ``generator``), of the mean where
        not. JAX's PRNG and torch's differ, so a caller that wants JAX's
        draws passes them as ``noise``."""
        mean, logvar = self.encode(x)
        if not sample:
            z = mean
        elif noise is not None:
            z = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
        else:
            z = sample_diagonal_gaussian(generator, mean, logvar)
        return self.decode(z), (mean, logvar)


def sample_diagonal_gaussian(generator: torch.Generator | None, mean: torch.Tensor,
                             logvar: torch.Tensor, eps: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """z = mean + std * eps: ``eps`` the standard normals of the latent's
    shape (float32) where given, else drawn from ``generator``; either way
    rounded to the latent's dtype."""
    if eps is None:
        eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                          dtype=torch.float32)
    return mean + torch.exp(0.5 * logvar) * eps.to(mean.dtype)


def diagonal_gaussian_kl(mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0,1)) per example (distributions.py:42-52, other=None),
    in fp32."""
    mean, logvar = mean.float(), logvar.float()
    return 0.5 * (mean.square() + logvar.exp() - 1.0 - logvar).sum(dim=tuple(range(1, mean.dim())))


@dataclasses.dataclass
class AutoencoderKLConfig:
    """configs/v1.yaml first_stage_config-compatible constructor."""

    ddconfig: dict[str, Any]
    embed_dim: int = 4
    lossconfig: Any = None
    monitor: str | None = None
    ckpt_path: str | None = None
    ignore_keys: tuple = ()
    image_key: str = "image"
    colorize_nlabels: int | None = None

    def build(self, dtype: torch.dtype = torch.float32,
              attn_impl: str = "plain") -> AutoencoderKL:
        dd = self.ddconfig
        return AutoencoderKL(
            ch=dd.get("ch", 128), out_ch=dd.get("out_ch", 3),
            ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
            num_res_blocks=dd.get("num_res_blocks", 2),
            z_channels=dd.get("z_channels", 4), embed_dim=self.embed_dim,
            in_channels=dd.get("in_channels", 3), dtype=dtype, attn_impl=attn_impl,
        )
