"""Detail-preserving composite (port of ``feather_mask`` and ``paste_back``
from ``pbe_tpu/models/vae_asym.py``).

The decoder round-trips every pixel, which softens detail the edit never
touched; ``paste_back`` composites the decoded edit over the original
pixels with a feathered mask: zero extra FLOPs, every mask==1 (keep) pixel
bit-exact, a short feather hiding the seam. NHWC tensors, mask==1 keep.
"""
from __future__ import annotations

import torch


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
