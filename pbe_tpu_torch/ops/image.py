"""Image ops and normalization constants (port of ``pbe_tpu/ops/image.py``)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# CLIP preprocessing statistics (reference scripts/inference.py:42-43)
CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of NCHW."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_mask(mask: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(B,H,W,1) mask -> (B,h,w,1) by bilinear resize with antialiasing,
    which is what ``jax.image.resize(..., "bilinear")`` does when it
    downsamples (without antialiasing the two disagree badly at 512->64).
    Computed in fp32 and returned in the mask's dtype."""
    x = mask.permute(0, 3, 1, 2).float()
    y = F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1).to(mask.dtype)
