"""Exemplar (reference-image) augmentation and preprocessing (port of
``pbe_tpu/data/augment.py``).

The strong augmentation that breaks the copy-paste shortcut: resize to
224, horizontal flip p=0.5, rotation ±20°, gaussian blur p=0.3 (the
fork's clip_aug, open-images.py:157-162; upstream also jittered colour,
behind ``color_jitter``). Host-side PIL/numpy; outputs are CLIP-normalized
float32 HWC. The random draws come in the JAX package's order (flip,
angle, blur, radius, jitter), so one generator state gives the same image.
"""
from __future__ import annotations

import numpy as np
from PIL import Image, ImageFilter

from pbe_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD


def augment_exemplar(
    img: Image.Image,
    rng: np.random.Generator,
    size: int = 224,
    flip_p: float = 0.5,
    max_rotate_deg: float = 20.0,
    blur_p: float = 0.3,
    color_jitter: float = 0.0,
    normalize: bool = True,
) -> np.ndarray:
    """normalize=False returns the augmented uint8 pixels instead of the
    CLIP-normalized float (the uint8 transfer path normalizes on the
    device; identical values, since the host float is u8/255 exactly).
    color_jitter operates in float space and requires normalize=True."""
    img = img.resize((size, size), Image.BICUBIC)
    if rng.uniform() < flip_p:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    deg = rng.uniform(-max_rotate_deg, max_rotate_deg)
    img = img.rotate(deg, resample=Image.BILINEAR)
    if rng.uniform() < blur_p:
        img = img.filter(ImageFilter.GaussianBlur(radius=rng.uniform(0.5, 1.5)))
    if not normalize:
        if color_jitter:
            raise ValueError("color_jitter needs the float path (normalize=True)")
        return np.asarray(img)
    x = np.asarray(img, np.float32) / 255.0
    if color_jitter > 0:
        scale = 1.0 + rng.uniform(-color_jitter, color_jitter, size=(1, 1, 3))
        shift = rng.uniform(-color_jitter, color_jitter, size=(1, 1, 3))
        x = np.clip(x * scale + shift, 0.0, 1.0).astype(np.float32)
    return ((x - CLIP_MEAN) / CLIP_STD).astype(np.float32)


def clip_preprocess(img: Image.Image, size: int = 224) -> np.ndarray:
    """Deterministic CLIP preprocessing (eval-time)."""
    img = img.resize((size, size), Image.BICUBIC)
    x = np.asarray(img, np.float32) / 255.0
    return ((x - CLIP_MEAN) / CLIP_STD).astype(np.float32)
