"""Exemplar (reference-image) encoder (port of ``pbe_tpu/models/exemplar.py``).

CLIP ViT-L/14 pooler_output (1024) -> one token -> 5-layer width-1024 mapper
-> final LayerNorm. The mapper attends over exactly one token, so its
attention is the value path: out = c_proj(v), v the last third of c_qkv(x).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from pbe_tpu_torch.models.clip_vit import CLIPVisionConfig
from pbe_tpu_torch.models.layers import Linear
from pbe_tpu_torch.ops.norms import LayerNormF32


class _MapperAttention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_qkv = Linear(width, width * 3)
        self.c_proj = Linear(width, width)


class _MapperMLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = Linear(width, width * 4)
        self.c_proj = Linear(width * 4, width)


class MapperBlock(nn.Module):
    """xf.ResidualAttentionBlock specialized to one token."""

    def __init__(self, width: int):
        super().__init__()
        self.width = width
        self.ln_1 = LayerNormF32(width)
        self.attn = _MapperAttention(width)
        self.ln_2 = LayerNormF32(width)
        self.mlp = _MapperMLP(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.attn.c_qkv(self.ln_1(x))[..., 2 * self.width:]
        x = x + self.attn.c_proj(v)
        h = self.mlp.c_fc(self.ln_2(x))
        h = F.gelu(h.float()).to(h.dtype)  # exact GELU in fp32
        return x + self.mlp.c_proj(h)


class Mapper(nn.Module):
    def __init__(self, width: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList([MapperBlock(width) for _ in range(layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x)
        return x


class ExemplarEncoder(nn.Module):
    """(B, 224, 224, 3) CLIP-normalized NHWC -> (B, 1, 1024) token."""

    def __init__(self, clip: CLIPVisionConfig, mapper_layers: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.transformer = clip.build(dtype)
        self.mapper = Mapper(clip.hidden_size, mapper_layers)
        self.final_ln = LayerNormF32(clip.hidden_size)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        return self.map_pooled(self.transformer(image)[1])

    def map_pooled(self, pooled: torch.Tensor) -> torch.Tensor:
        """The trainable tail: (B, 1024) pooled CLIP output -> (B, 1, 1024)."""
        return self.final_ln(self.mapper(pooled[:, None, :]))


@dataclasses.dataclass
class ExemplarEncoderConfig:
    """cond_stage_config-compatible constructor (configs/v1.yaml:71-72)."""

    version: str = "openai/clip-vit-large-patch14"
    clip: CLIPVisionConfig | None = None
    mapper_layers: int = 5

    def __post_init__(self):
        if isinstance(self.clip, dict):  # YAML-provided override geometry
            self.clip = CLIPVisionConfig(**self.clip)

    def build(self, dtype: torch.dtype = torch.float32) -> ExemplarEncoder:
        return ExemplarEncoder(self.clip or CLIPVisionConfig(), self.mapper_layers, dtype)
