"""Fold/unfold spatial tiling (port of ``pbe_tpu/ops/tiling.py``): the
reference's ``split_input_params`` path.

The reference's delta_border / get_weighting / get_fold_unfold and its tiled
apply_model loop (latent_diffusion.py:280-367, 656-736), with one change the
JAX package made: the reference calls the model once per crop in a Python
loop, and here all L crops go into the batch dimension, crop-major, for ONE
call at batch L*B. The border-distance weighting is the reference's bit for
bit (a numpy copy of the JAX package's): normalized distance to the nearest
border clipped to [clip_min_weight, clip_max_weight], optionally times the
same map over the (Ly, Lx) crop grid.

``uf``/``df``: the wrapped function up- or downsamples its crop by that
factor (a VAE decode: uf=8; an encode: df=8), and the crops are stitched at
the output's resolution. Tiling is opt-in: ``EditPipeline(tiling=
TilingSpec(...))`` or the edit CLI's ``--tile_ks/--tile_stride`` wrap the
eps model inside the sampler loop (pipelines/inference.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TilingSpec:
    """The split_input_params that set the crop grid and the weighting
    (latent_diffusion.py:302-316; configs use e.g. ks=(128,128),
    stride=(64,64))."""

    ks: tuple[int, int]
    stride: tuple[int, int]
    clip_min_weight: float = 0.01
    clip_max_weight: float = 0.5
    tie_braker: bool = True
    clip_min_tie_weight: float = 0.01
    clip_max_tie_weight: float = 0.5


def delta_border(h: int, w: int) -> np.ndarray:
    """Normalized distance to the nearest border: 0 at the edge, 0.5 at the
    centre (latent_diffusion.py:286-298). A 1-wide axis (a single-crop
    grid's tie-breaker map) takes a guarded denominator instead of the
    reference's 0/0 NaN; the constant cancels in the fold's num/den."""
    y = np.broadcast_to(np.arange(h, dtype=np.float64)[:, None] / max(h - 1, 1), (h, w))
    x = np.broadcast_to(np.arange(w, dtype=np.float64)[None, :] / max(w - 1, 1), (h, w))
    dist = np.minimum.reduce([y, x, 1.0 - y, 1.0 - x])
    return dist.astype(np.float32)


def tile_weighting(kh: int, kw: int, ly: int, lx: int, spec: TilingSpec) -> np.ndarray:
    """Per-pixel stitch weights for one crop, (kh, kw, ly*lx)
    (latent_diffusion.py:300-316)."""
    w = np.clip(delta_border(kh, kw), spec.clip_min_weight, spec.clip_max_weight)
    w = np.repeat(w[:, :, None], ly * lx, axis=2)
    if spec.tie_braker:
        tie = np.clip(delta_border(ly, lx), spec.clip_min_tie_weight,
                      spec.clip_max_tie_weight).reshape(-1)
        w = w * tie[None, None, :]
    return w.astype(np.float32)


def _grid(h: int, w: int, ks: tuple[int, int], stride: tuple[int, int]) -> tuple[int, int]:
    ly = (h - ks[0]) // stride[0] + 1
    lx = (w - ks[1]) // stride[1] + 1
    if ly < 1 or lx < 1:
        raise ValueError(f"kernel {ks} larger than input ({h}, {w})")
    if (h - ks[0]) % stride[0] or (w - ks[1]) % stride[1]:
        raise ValueError(
            f"tiling must cover the input exactly: ({h},{w}) with ks={ks} stride={stride} "
            "leaves a remainder (same constraint as torch Fold/Unfold round-tripping)")
    return ly, lx


def unfold(x: torch.Tensor, ks: tuple[int, int], stride: tuple[int, int]) -> torch.Tensor:
    """x (B, H, W, C) -> crops (L, B, kh, kw, C), row-major over the grid
    (torch Unfold's order, latent_diffusion.py:668-671)."""
    _, h, w, _ = x.shape
    ly, lx = _grid(h, w, ks, stride)
    return torch.stack([x[:, iy * stride[0]:iy * stride[0] + ks[0],
                          ix * stride[1]:ix * stride[1] + ks[1], :]
                        for iy in range(ly) for ix in range(lx)], dim=0)


def fold(crops: torch.Tensor, out_hw: tuple[int, int],
         stride: tuple[int, int]) -> torch.Tensor:
    """crops (L, B, kh, kw, C) -> (B, H, W, C) by overlap-summing (torch
    Fold's semantics), crop by crop in grid order."""
    l, b, kh, kw, c = crops.shape
    h, w = out_hw
    ly, lx = _grid(h, w, (kh, kw), stride)
    assert ly * lx == l, (ly, lx, l)
    out = torch.zeros((b, h, w, c), dtype=crops.dtype, device=crops.device)
    for i in range(l):
        iy, ix = divmod(i, lx)
        out[:, iy * stride[0]:iy * stride[0] + kh,
            ix * stride[1]:ix * stride[1] + kw, :] += crops[i]
    return out


def tiled_apply(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                spec: TilingSpec, uf: int = 1, df: int = 1) -> torch.Tensor:
    """Apply ``fn`` over overlapping crops of x (B, H, W, C) and stitch them
    with the border weighting (latent_diffusion.py:656-736 / 444-508,
    batched over crops). fn maps (N, kh, kw, C) -> (N, kh*uf/df, kw*uf/df,
    C'); at most one of uf/df may exceed 1 (upsampling decode /
    downsampling encode)."""
    if uf > 1 and df > 1:
        raise NotImplementedError("uf and df cannot both exceed 1")
    b, h, w, _ = x.shape
    ks, stride = spec.ks, spec.stride
    ly, lx = _grid(h, w, ks, stride)
    scale = uf if uf > 1 else 1
    down = df if df > 1 else 1
    if df > 1 and (ks[0] % df or ks[1] % df or stride[0] % df or stride[1] % df):
        raise ValueError("ks/stride must be divisible by df")

    crops = unfold(x, ks, stride)  # (L, B, kh, kw, C)
    l = crops.shape[0]
    out = fn(crops.reshape(l * b, *crops.shape[2:]))  # ONE batched call for all crops
    okh, okw = ks[0] * scale // down, ks[1] * scale // down
    if tuple(out.shape[1:3]) != (okh, okw):
        raise ValueError(f"fn returned spatial {tuple(out.shape[1:3])}, expected ({okh}, "
                         f"{okw}) for uf={uf} df={df}")
    out = out.reshape(l, b, okh, okw, out.shape[-1])

    weighting = torch.from_numpy(tile_weighting(okh, okw, ly, lx, spec)).to(out.device)
    # (kh, kw, L) -> (L, 1, kh, kw, 1), to broadcast over batch and channels
    wgt = weighting.permute(2, 0, 1)[:, None, :, :, None].to(out.dtype)
    ostride = (stride[0] * scale // down, stride[1] * scale // down)
    out_hw = (h * scale // down, w * scale // down)
    num = fold(out * wgt, out_hw, ostride)
    den = fold(wgt, out_hw, ostride)
    return num / den
