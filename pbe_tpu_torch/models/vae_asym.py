"""Detail-preserving decode (port of ``pbe_tpu/models/vae_asym.py``).

The decoder round-trips every pixel, which softens detail the edit never
touched. Two remedies, in increasing fidelity:

1. ``paste_back`` composites the decoded edit over the original pixels with
   a feathered mask: zero extra FLOPs, every mask==1 (keep) pixel
   bit-exact, a short feather hiding the seam.
2. ``AsymmetricDecoder`` (the asymmetric-VQGAN design, arXiv:2306.04632):
   the plain decoder trunk, whose module names are ``Decoder``'s so a
   first-stage state_dict loads into it, plus a conv pyramid over the
   unmasked original pixels and the mask whose features are mask-blended
   into the trunk at every resolution behind zero-init gates; with the
   gates at zero it computes exactly the plain decode.

NHWC tensors at the public functions, mask==1 keep; the blocks run NCHW.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pbe_tpu_torch.models.layers import Conv2d, to_nchw, to_nhwc
from pbe_tpu_torch.models.vae import Decoder, Downsample, ResnetBlock


def feather_mask(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Soften a {0,1} keep-mask (N,H,W,1) with ``radius`` passes of a
    separable 3-tap [1/4, 1/2, 1/4] blur over edge-padded borders; every
    originally kept pixel keeps weight 1, so the feather eats into the edit
    region only."""
    if radius <= 0:
        return mask
    m = mask
    for _ in range(radius):
        for dim in (1, 2):
            n = m.shape[dim]
            first, last = m.narrow(dim, 0, 1), m.narrow(dim, n - 1, 1)
            p = torch.cat([first, m, last], dim=dim)
            m = 0.25 * p.narrow(dim, 0, n) + 0.5 * m + 0.25 * p.narrow(dim, 2, n)
    return torch.where(mask >= 1.0, torch.ones_like(m), m)


def paste_back(decoded: torch.Tensor, original: torch.Tensor, mask: torch.Tensor,
               feather: int = 8) -> torch.Tensor:
    """Original pixels where mask==1 (keep), decoded pixels where mask==0,
    a feathered transition in between. decoded/original: (N,H,W,3) in one
    value range; mask: (N,H,W,1). feather=0 is a hard composite."""
    w = feather_mask(mask.to(decoded.dtype), feather)
    return original * w + decoded * (1.0 - w)


class MaskCondEncoder(nn.Module):
    """Conv pyramid over concat(masked original, mask) producing one feature
    map per decode-trunk resolution (the paper's conditional branch):
    widths cond_ch * ch_mult[i], the encoder's pyramid (the last level stays
    at latent resolution), plus one more block at latent resolution."""

    def __init__(self, ch: int, ch_mult: Sequence[int]):
        super().__init__()
        self.conv_in = Conv2d(4, ch * ch_mult[0], 3, padding=1)
        blocks, downs, block_in = [], [], ch * ch_mult[0]
        for i, mult in enumerate(ch_mult):
            blocks.append(ResnetBlock(block_in, ch * mult))
            block_in = ch * mult
            if i != len(ch_mult) - 1:
                downs.append(Downsample(block_in))
        self.level_block = nn.ModuleList(blocks)
        self.level_down = nn.ModuleList(downs)
        self.latent_block = ResnetBlock(block_in, block_in)

    def forward(self, cond: torch.Tensor, mask: torch.Tensor) -> list[torch.Tensor]:
        """cond (N,C,H,W) unmasked-original pixels in [-1, 1], mask
        (N,1,H,W), 1 = keep -> NCHW features, index i <-> trunk level i (0
        finest), index len(ch_mult) <-> the latent resolution."""
        h = self.conv_in(torch.cat([cond * mask, mask], dim=1))
        feats = []
        for i, block in enumerate(self.level_block):
            h = block(h)
            feats.append(h)
            if i < len(self.level_down):
                h = self.level_down[i](h)
        feats.append(self.latent_block(h))
        return feats


def _mask_at(mask: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-resize an NCHW keep-mask to a trunk resolution as
    ``jax.image.resize(..., "nearest")`` does: output pixel i takes input
    pixel floor((i + 0.5) * in / out)."""
    for dim, out in zip((2, 3), hw):
        size = mask.shape[dim]
        idx = ((torch.arange(out, dtype=torch.float32, device=mask.device) + 0.5)
               * size / out).floor().long()
        mask = mask.index_select(dim, idx)
    return mask


class AsymmetricDecoder(Decoder):
    """``vae.Decoder`` trunk + mask-blended conditional features. Each
    resolution blends the conditional feature in inside the keep region
    only, ``h <- h + scale_i * m_i * (f_i - h)``, with ``scale_i`` a
    learnable scalar starting at 0 (``blend_scale``); where the feature's
    width differs from the trunk's, a 1x1 ``cond_proj`` maps it."""

    def __init__(self, ch: int = 128, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, cond_ch: int = 32,
                 attn_impl: str = "plain", dtype: torch.dtype = torch.float32):
        super().__init__(ch, out_ch, ch_mult, num_res_blocks, z_channels, attn_impl)
        self.dtype = dtype
        self.cond_encoder = MaskCondEncoder(cond_ch, ch_mult)
        n = len(ch_mult)
        widths = [ch * m for m in ch_mult] + [ch * ch_mult[-1]]
        cond_widths = [cond_ch * m for m in ch_mult] + [cond_ch * ch_mult[-1]]
        self.cond_proj = nn.ModuleDict({
            str(i): Conv2d(cond_widths[i], widths[i], 1)
            for i in range(n + 1) if cond_widths[i] != widths[i]})
        self.blend_scale = nn.Parameter(torch.zeros(n + 1))

    def _blend(self, h: torch.Tensor, feats: list, mask: torch.Tensor, idx: int) -> torch.Tensor:
        f = feats[idx]
        if str(idx) in self.cond_proj:
            f = self.cond_proj[str(idx)](f)
        m = _mask_at(mask.to(h.dtype), tuple(h.shape[2:]))
        return h + self.blend_scale[idx].to(h.dtype) * m * (f - h)

    def forward(self, z: torch.Tensor, cond: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """z (N,h,w,z_channels), cond (N,H,W,3) in [-1, 1], mask (N,H,W,1)
        with 1 = keep, all NHWC -> the decoded image, NHWC."""
        mask = to_nchw(mask).to(self.dtype)
        feats = self.cond_encoder(to_nchw(cond).to(self.dtype), mask)
        h = self.mid(self.conv_in(to_nchw(z).to(self.dtype)))
        h = self._blend(h, feats, mask, len(self.up))
        for i in reversed(range(len(self.up))):
            level = self.up[i]
            for block in level.block:
                h = block(h)
            h = self._blend(h, feats, mask, i)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return to_nhwc(self.conv_out(F.silu(self.norm_out(h))))


@dataclasses.dataclass
class AsymmetricDecoderConfig:
    """YAML-constructible spec mirroring first_stage ddconfig keys."""

    ddconfig: dict[str, Any]
    cond_ch: int = 32

    def build(self, dtype: torch.dtype = torch.float32,
              attn_impl: str = "plain") -> AsymmetricDecoder:
        dd = self.ddconfig
        return AsymmetricDecoder(
            ch=dd.get("ch", 128), out_ch=dd.get("out_ch", 3),
            ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
            num_res_blocks=dd.get("num_res_blocks", 2),
            z_channels=dd.get("z_channels", 4), cond_ch=self.cond_ch,
            attn_impl=attn_impl, dtype=dtype,
        )
