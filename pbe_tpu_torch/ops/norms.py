"""Normalization layers with fp32 islands (port of ``pbe_tpu/ops/norms.py``).

GroupNorm and LayerNorm statistics are computed in float32 whatever the
compute dtype, and the result is cast back to the input's dtype, as the
reference's GroupNorm32 and fp32 LayerNorm do under autocast.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pbe_tpu_torch.ops.conv import as_dtype

f32 = torch.float32


class GroupNorm32(nn.Module):
    """GroupNorm over NCHW in fp32. groups = gcd(32, C): every production
    width is a multiple of 32; the gcd only matters for tiny test widths.

    eps is 1e-5 in UNet ResBlocks and the UNet head, 1e-6 in the
    SpatialTransformer norm and throughout the VAE."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.groups = math.gcd(32, channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(as_dtype(x, f32), self.groups, as_dtype(self.weight, f32),
                         as_dtype(self.bias, f32), self.eps)
        return as_dtype(y, x.dtype)


class LayerNormF32(nn.Module):
    """LayerNorm over the last axis in fp32, eps 1e-5 (CLIP's and the UNet's)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(as_dtype(x, f32), self.weight.shape, as_dtype(self.weight, f32),
                         as_dtype(self.bias, f32), 1e-5)
        return as_dtype(y, x.dtype)
