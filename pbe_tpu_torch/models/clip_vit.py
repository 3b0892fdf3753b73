"""CLIP ViT vision tower (port of ``pbe_tpu/models/clip_vit.py``).

HuggingFace ``CLIPVisionModel`` semantics as used by the reference's
FrozenCLIPImageEmbedder: the PBE conditioning consumes only ``pooler_output``
(the post-layernormed CLS token). ViT-L/14: hidden 1024, 24 layers, 16 heads,
MLP 4096, patch 14, image 224, quick-GELU. Attention is the plain einsum
path with an fp32 softmax, as in the JAX package. Module names follow the
HF state_dict (``vision_model.embeddings.patch_embedding`` ...).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from pbe_tpu_torch.models.layers import Conv2d, Linear, to_nchw
from pbe_tpu_torch.ops.attention import multi_head_attention
from pbe_tpu_torch.ops.norms import LayerNormF32


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(dim, dim)
        self.k_proj = Linear(dim, dim)
        self.v_proj = Linear(dim, dim)
        self.out_proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = multi_head_attention(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                                   self.heads, impl="plain")
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.fc1 = Linear(dim, mlp_dim)
        self.fc2 = Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.layer_norm1 = LayerNormF32(dim)
        self.self_attn = CLIPAttention(dim, heads)
        self.layer_norm2 = LayerNormF32(dim)
        self.mlp = CLIPMLP(dim, mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(dim, heads, mlp_dim)
                                     for _ in range(num_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class CLIPEmbeddings(nn.Module):
    def __init__(self, hidden: int, patch: int, image: int):
        super().__init__()
        self.patch_embedding = Conv2d(3, hidden, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(hidden))
        self.position_embedding = nn.Embedding((image // patch) ** 2 + 1, hidden)

    def forward(self, pixels_nchw: torch.Tensor) -> torch.Tensor:
        b = pixels_nchw.shape[0]
        patches = self.patch_embedding(pixels_nchw).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(patches.dtype).expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        return x + self.position_embedding.weight.to(x.dtype)[None]


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: "CLIPVisionConfig"):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg.hidden_size, cfg.patch_size, cfg.image_size)
        self.pre_layrnorm = LayerNormF32(cfg.hidden_size)  # HF spells it this way
        self.encoder = CLIPEncoder(cfg.hidden_size, cfg.num_heads, cfg.mlp_dim,
                                   cfg.num_layers)
        self.post_layernorm = LayerNormF32(cfg.hidden_size)

    def forward(self, pixels_nchw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixels_nchw)))
        return x, self.post_layernorm(x[:, 0])


class CLIPVisionTower(nn.Module):
    """pixel_values NHWC (CLIP-normalized) -> (last_hidden_state, pooler_output)."""

    def __init__(self, cfg: "CLIPVisionConfig", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.vision_model = CLIPVisionTransformer(cfg)

    def forward(self, pixel_values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.vision_model(to_nchw(pixel_values).to(self.dtype))


@dataclasses.dataclass
class CLIPVisionConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    patch_size: int = 14
    image_size: int = 224

    def build(self, dtype: torch.dtype = torch.float32) -> CLIPVisionTower:
        return CLIPVisionTower(self, dtype)
