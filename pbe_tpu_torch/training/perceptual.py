"""VGG16 perceptual (LPIPS-style) feature loss for VAE-GAN training (port of
``pbe_tpu/training/perceptual.py``).

Behavioral reference: the LPIPS perceptual term inside the reference's
LPIPSWithDiscriminator (ldm/modules/losses/contperceptual.py:7-60, via
``taming.modules.losses.LPIPS``): a VGG16 feature stack evaluated at
relu{1_2, 2_2, 3_3, 4_3, 5_3}, channel-unit-normalized, squared difference,
spatially averaged, summed over layers, returned per sample so that it
broadcasts onto the elementwise reconstruction loss.

The tower's module keys are torchvision's ``vgg16().features`` keys, so a
torchvision state_dict loads through :func:`convert_torchvision_vgg16`
(classifier keys dropped; nothing is downloaded). LPIPS's learned linear
layers are replaced by per-layer scalars (default 1.0). Images in [-1, 1]
(NHWC at the public functions), scaled by LPIPS's ScalingLayer constants.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from pbe_tpu_torch.models.layers import Conv2d, to_nchw

# torchvision vgg16.features conv indices, grouped by block; a 2x2 maxpool
# follows each block. Feature taps are the last relu of each block.
_BLOCKS: tuple[tuple[int, ...], ...] = ((0, 2), (5, 7), (10, 12, 14),
                                        (17, 19, 21), (24, 26, 28))
_CHANNELS = (64, 128, 256, 512, 512)

# LPIPS ScalingLayer constants (maps [-1,1] inputs to VGG's expected stats)
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


class VGG16Features(nn.Module):
    """VGG16 conv tower returning the five LPIPS feature taps (NCHW).
    Parameters are fp32; the convs compute in ``dtype``."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.features = nn.ModuleDict()
        cin = 3
        for idxs, ch in zip(_BLOCKS, _CHANNELS):
            for i in idxs:
                self.features[str(i)] = Conv2d(cin, ch, 3, padding=1)
                cin = ch
        self.register_buffer("shift", torch.from_numpy(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.from_numpy(_SCALE), persistent=False)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x (N,H,W,3) in [-1, 1] -> the five taps, NCHW in ``dtype``."""
        h = to_nchw((x.float() - self.shift) / self.scale).to(self.dtype)
        taps = []
        for b, idxs in enumerate(_BLOCKS):
            if b:
                h = F.max_pool2d(h, 2, 2)
            for i in idxs:
                h = F.relu(self.features[str(i)](h))
            taps.append(h)
        return taps


def convert_torchvision_vgg16(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """torchvision ``vgg16().state_dict()`` (or its ``features.*`` subset)
    -> the VGG16Features state_dict. Classifier keys are ignored."""
    out = {}
    for idxs in _BLOCKS:
        for i in idxs:
            for leaf in ("weight", "bias"):
                v = state_dict[f"features.{i}.{leaf}"]
                out[f"features.{i}.{leaf}"] = torch.as_tensor(np.asarray(v, np.float32))
    return out


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + eps)


def make_vgg_perceptual_fn(
    tower: VGG16Features,
    layer_weights: Sequence[float] | None = None,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Build perceptual_fn(x, y) -> (B,1,1,1) fp32 distance, pluggable into
    make_vae_train_step(perceptual_fn=...). ``tower`` holds the weights
    (frozen: its parameters get no gradient). layer_weights replaces
    LPIPS's learned 1x1 'lin' layers with per-layer scalars (default 1.0
    each)."""
    tower.requires_grad_(False)
    w = layer_weights or (1.0,) * len(_BLOCKS)

    def perceptual_fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for a, b, wl in zip(tower(x), tower(y), w):
            d = (_unit_normalize(a.float()) - _unit_normalize(b.float())).square()
            total = total + wl * d.mean(dim=(1, 2, 3))
        return total[:, None, None, None]

    return perceptual_fn
