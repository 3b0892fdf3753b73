"""Legacy SD text and conditioning encoders (port of
``pbe_tpu/models/text_transformer.py``).

  * ``TextTransformer``    == ldm/modules/x_transformer.py:548-641
    (``TransformerWrapper`` over a plain pre-norm ``Encoder``, the only
    configuration the SD configs instantiate: token embedding + absolute
    positional embedding + depth x [self-attention, GELU MLP] pre-LayerNorm
    residual blocks + final LayerNorm; ``return_embeddings`` skips the
    logit head). The research knobs the reference carries but never
    enables (rezero, scalenorm, talking heads, memory tokens, macaron,
    sandwich/PAR layouts, entmax) are not ported, as in the JAX package.
  * ``TransformerEmbedderConfig`` == ldm/modules/encoders/modules.py:36-51
  * ``BERTEmbedderConfig``        == ldm/modules/encoders/modules.py:80-103
    (the HF BERT tokenizer needs its vocabulary files on disk; tokenization
    is behind ``use_tokenizer`` as in the reference and raises a clear
    error where the vocabulary is missing)
  * ``ClassEmbedder``             == ldm/modules/encoders/modules.py:21-33
  * ``SpatialRescaler``           == ldm/modules/encoders/modules.py:106-134

Sequences are at most 77 tokens and the JAX module's attention is a plain
fp32-softmax einsum, so this one is plain PyTorch too. The modules carry
the reference ``TransformerWrapper`` keys (``attn_layers.layers.{2i}`` the
attention and ``.{2i+1}`` the feed-forward, each ``.0`` its LayerNorm);
``convert.text_transformer_state_dict_from_flax`` carries the JAX params
across.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pbe_tpu_torch.models.layers import Conv2d, Linear
from pbe_tpu_torch.ops.image import jax_resize
from pbe_tpu_torch.ops.norms import LayerNormF32


class _SelfAttention(nn.Module):
    """x_transformer.Attention in its default configuration
    (x_transformer.py:215-267): per-head scale 1/sqrt(dim_head), no-bias
    q/k/v projections, biased output projection, fp32 softmax."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(dim, inner, bias=False)
        self.to_v = Linear(dim, inner, bias=False)
        self.to_out = Linear(inner, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        b, n, _ = x.shape
        split = lambda t: t.reshape(b, n, self.heads, self.dim_head)
        q, k, v = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x))
        s = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * self.dim_head ** -0.5
        if mask is not None:
            # a boolean (B, N) keep-mask on both sides (x_transformer.py:303-311)
            pair = mask[:, None, :, None] & mask[:, None, None, :]
            s = torch.where(pair, s, torch.finfo(torch.float32).min)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        return self.to_out(torch.einsum("bhij,bjhd->bihd", p, v).reshape(b, n, -1))


class _GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate.float()).to(h.dtype)


class _GELU(nn.Module):
    """Exact GELU in fp32, cast back."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x.float()).to(x.dtype)


class _FeedForward(nn.Module):
    """x_transformer.FeedForward (x_transformer.py:194-211): Linear -> exact
    GELU -> Linear (mult 4), or GEGLU when ``glu``."""

    def __init__(self, dim: int, mult: int = 4, glu: bool = False):
        super().__init__()
        inner = int(dim * mult)
        project_in = _GEGLU(dim, inner) if glu else nn.Sequential(Linear(dim, inner), _GELU())
        self.net = nn.Sequential(project_in, nn.Identity(), Linear(inner, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class _AttentionLayers(nn.Module):
    """The pre-norm Encoder's layers (AttentionLayers.forward:497-516)."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, ff_mult: int,
                 ff_glu: bool):
        super().__init__()
        self.layers = nn.ModuleList()
        for _ in range(depth):
            self.layers.append(nn.ModuleList([LayerNormF32(dim),
                                              _SelfAttention(dim, heads, dim_head)]))
            self.layers.append(nn.ModuleList([LayerNormF32(dim),
                                              _FeedForward(dim, ff_mult, ff_glu)]))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        for i, (norm, block) in enumerate(self.layers):
            x = x + (block(norm(x), mask=mask) if i % 2 == 0 else block(norm(x)))
        return x


class _AbsolutePositionalEmbedding(nn.Module):
    def __init__(self, dim: int, max_seq_len: int):
        super().__init__()
        self.emb = nn.Embedding(max_seq_len, dim)


class TextTransformer(nn.Module):
    """TransformerWrapper(num_tokens, max_seq_len, Encoder(dim, depth)).

    forward(tokens int (B, N <= max_seq_len)) -> embeddings (B, N, dim) when
    ``return_embeddings`` (the SD text path, modules.py:46,97) else logits
    (B, N, num_tokens)."""

    def __init__(self, num_tokens: int, max_seq_len: int, dim: int, depth: int, heads: int = 8,
                 dim_head: int = 64, ff_mult: int = 4, ff_glu: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.token_emb = nn.Embedding(num_tokens, dim)
        self.pos_emb = _AbsolutePositionalEmbedding(dim, max_seq_len)
        self.attn_layers = _AttentionLayers(dim, depth, heads, dim_head, ff_mult, ff_glu)
        self.norm = LayerNormF32(dim)
        self.to_logits = Linear(dim, num_tokens)
        for emb in (self.token_emb, self.pos_emb.emb):  # init_(), x_transformer.py:593
            nn.init.normal_(emb.weight, std=0.02)

    def forward(self, tokens: torch.Tensor, return_embeddings: bool = False,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        pos = self.pos_emb.emb(torch.arange(tokens.shape[1], device=tokens.device))
        x = (self.token_emb(tokens) + pos[None]).to(self.dtype)
        x = self.norm(self.attn_layers(x, mask=mask))
        return x if return_embeddings else self.to_logits(x)


@dataclasses.dataclass
class TransformerEmbedderConfig:
    """ldm.modules.encoders.modules.TransformerEmbedder's constructor
    surface (modules.py:36-43); ``device`` is accepted for config parity
    (``build`` makes the module on the CPU; move it with ``.to``)."""

    n_embed: int
    n_layer: int
    vocab_size: int
    max_seq_len: int = 77
    device: str = "cuda"

    def build(self, dtype: torch.dtype = torch.float32) -> TextTransformer:
        return TextTransformer(num_tokens=self.vocab_size, max_seq_len=self.max_seq_len,
                               dim=self.n_embed, depth=self.n_layer, dtype=dtype)


@dataclasses.dataclass
class BERTEmbedderConfig:
    """ldm.modules.encoders.modules.BERTEmbedder (modules.py:80-103): the
    LDM-BERT text encoder, a 30522-token TextTransformer; with
    ``use_tokenizer`` the input is raw text through the HF bert-base-uncased
    tokenizer (its vocabulary must be on disk; a clear error otherwise)."""

    n_embed: int
    n_layer: int
    vocab_size: int = 30522
    max_seq_len: int = 77
    use_tokenizer: bool = True
    embedding_dropout: float = 0.0  # accepted for config parity; eval-only path

    def build(self, dtype: torch.dtype = torch.float32) -> TextTransformer:
        return TextTransformer(num_tokens=self.vocab_size, max_seq_len=self.max_seq_len,
                               dim=self.n_embed, depth=self.n_layer, dtype=dtype)

    def tokenize(self, text: list[str]) -> np.ndarray:
        """Raw text -> (B, max_seq_len) int32 ids (BERTTokenizer,
        modules.py:53-77: padded/truncated to max_seq_len)."""
        try:
            from transformers import BertTokenizerFast

            tok = BertTokenizerFast.from_pretrained("bert-base-uncased")
        except Exception as e:  # the vocabulary is not on disk
            raise RuntimeError(
                "BERTEmbedder.use_tokenizer needs the bert-base-uncased vocab "
                "on disk (HF cache); tokenize offline or pass token ids") from e
        enc = tok(text, truncation=True, max_length=self.max_seq_len, return_length=True,
                  return_overflowing_tokens=False, padding="max_length", return_tensors="np")
        return enc["input_ids"].astype(np.int32)


class ClassEmbedder(nn.Module):
    """ldm.modules.encoders.modules.ClassEmbedder (modules.py:21-33):
    class id -> (B, 1, embed_dim) conditioning token."""

    def __init__(self, embed_dim: int, n_classes: int = 1000, key: str = "class"):
        super().__init__()
        self.key = key
        self.embedding = nn.Embedding(n_classes, embed_dim)

    def forward(self, batch: Mapping[str, torch.Tensor], key: str | None = None) -> torch.Tensor:
        return self.embedding(batch[key or self.key][:, None])


class SpatialRescaler(nn.Module):
    """ldm.modules.encoders.modules.SpatialRescaler (modules.py:106-134):
    n_stages x scale-by-multiplier resizes (``jax.image.resize``'s, as the
    JAX module takes them; "area" and "trilinear" as linear) and an
    optional 1x1 channel remap, over NCHW."""

    METHODS = ("nearest", "linear", "bilinear", "trilinear", "bicubic", "area")

    def __init__(self, n_stages: int = 1, method: str = "bilinear", multiplier: float = 0.5,
                 in_channels: int = 3, out_channels: int | None = None, bias: bool = False):
        super().__init__()
        if method not in self.METHODS:
            raise ValueError(f"method {method!r} (one of {self.METHODS})")
        self.n_stages = n_stages
        self.method = {"area": "linear", "trilinear": "linear"}.get(method, method)
        self.multiplier = multiplier
        if out_channels is not None:
            self.channel_mapper = Conv2d(in_channels, out_channels, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.n_stages):
            h, w = x.shape[2:]
            x = jax_resize(x, (int(h * self.multiplier), int(w * self.multiplier)), self.method)
        if hasattr(self, "channel_mapper"):
            x = self.channel_mapper(x)
        return x
