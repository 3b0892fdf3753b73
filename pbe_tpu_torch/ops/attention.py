"""Attention primitives (port of ``pbe_tpu/ops/attention.py``).

Two paths:
  * ``plain`` — einsum, softmax in fp32, cast back to the compute dtype
    (the reference CrossAttention semantics; CLIP always uses it).
  * ``flash`` — the fused forward kernel of ``ops/flash_attention.py``: on a
    CUDA tensor it launches the hand-written Hopper kernel (or raises), on a
    CPU tensor it runs that kernel's plain PyTorch version.

The 1-token cross-attention of PBE degenerates exactly: softmax over one key
is 1, so the output is the value of that token broadcast over all queries
(:func:`single_token_attention`).
"""
from __future__ import annotations

import torch

from pbe_tpu_torch.ops.flash_attention import flash_attention


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, *, impl: str = "plain") -> torch.Tensor:
    """q (B, Nq, H*D), k/v (B, Nk, H*D) -> (B, Nq, H*D)."""
    b, nq, inner = q.shape
    nk = k.shape[1]
    d = inner // num_heads
    qh = q.reshape(b, nq, num_heads, d)
    kh = k.reshape(b, nk, num_heads, d)
    vh = v.reshape(b, nk, num_heads, d)
    if impl == "flash":
        return flash_attention(qh, kh, vh).reshape(b, nq, inner)
    if impl != "plain":
        raise ValueError(f"unknown attention impl {impl!r}")
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float())
    weights = torch.softmax(logits * d**-0.5, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), vh.float())
    return out.to(v.dtype).reshape(b, nq, inner)


def single_token_attention(v: torch.Tensor, num_queries: int) -> torch.Tensor:
    """Exact attention output for a one-token context: (B,1,C) -> (B,N,C)."""
    return v.expand(v.shape[0], num_queries, v.shape[2])
