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


# jax.image.resize's method names -> its kernels (ResizeMethod.from_string)
_RESIZE_METHODS = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
                   "trilinear": "linear", "triangle": "linear", "cubic": "cubic",
                   "bicubic": "cubic", "tricubic": "cubic", "lanczos3": "lanczos3",
                   "lanczos5": "lanczos5"}


def _kernel(kind: str, x: torch.Tensor) -> torch.Tensor:
    """jax.image's interpolation kernels at |offset| x (fp32)."""
    if kind == "linear":
        return torch.clamp(1.0 - x.abs(), min=0.0)
    if kind == "cubic":  # Keys, a = -0.5
        out = ((1.5 * x - 2.5) * x) * x + 1.0
        out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
        return torch.where(x >= 2.0, 0.0, out)
    radius = float(kind.removeprefix("lanczos"))
    y = radius * torch.sin(np.pi * x) * torch.sin(np.pi * x / radius)
    out = torch.where(x > 1e-3, y / torch.where(x != 0, np.pi ** 2 * x ** 2, 1.0), 1.0)
    return torch.where(x > radius, 0.0, out)


def resize_weights(in_size: int, out_size: int, kind: str, device=None) -> torch.Tensor:
    """(in_size, out_size) fp32 weights of ``jax.image.resize`` along one
    axis (``compute_weight_mat`` with antialiasing: the kernel is widened
    by the inverse scale when downsampling), normalized per output pixel,
    zero where the sample lies outside the input."""
    f32 = torch.float32
    inv = torch.tensor(1.0 / (out_size / in_size), dtype=f32)
    kernel_scale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(out_size, dtype=f32) + 0.5) * inv - 0.5
    w = _kernel(kind, (sample[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs()
                / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def jax_resize(x: torch.Tensor, hw: tuple[int, int], method: str) -> torch.Tensor:
    """``jax.image.resize`` of an NCHW tensor to spatial size ``hw``: with
    "nearest" the input pixel at floor((i + 0.5) * in / out) (half-pixel
    centres, which torch's "nearest" does not use at a fractional factor),
    else a product with :func:`resize_weights` along each axis whose size
    changes, in fp32, returned in the input's dtype."""
    kind = _RESIZE_METHODS[method]
    out = x
    for axis, n in ((2, hw[0]), (3, hw[1])):
        m = out.shape[axis]
        if m == n:
            continue
        if kind == "nearest":
            idx = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * m / n).long()
            out = out.index_select(axis, idx.to(x.device))
        else:
            w = resize_weights(m, n, kind, x.device)
            eq = "bchw,hi->bciw" if axis == 2 else "bchw,wj->bchj"
            out = torch.einsum(eq, out.float(), w)
    return out.to(x.dtype)
