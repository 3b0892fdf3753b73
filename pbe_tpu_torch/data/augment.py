"""Exemplar preprocessing (the port's own copy of ``clip_preprocess`` from
``pbe_tpu/data/augment.py``): host-side PIL/numpy, CLIP-normalized float32
HWC."""
from __future__ import annotations

import numpy as np
from PIL import Image

from pbe_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD


def clip_preprocess(img: Image.Image, size: int = 224) -> np.ndarray:
    """Deterministic CLIP preprocessing (eval-time)."""
    img = img.resize((size, size), Image.BICUBIC)
    x = np.asarray(img, np.float32) / 255.0
    return ((x - CLIP_MEAN) / CLIP_STD).astype(np.float32)
