"""Mask rasterization (the port's own copy of ``bbox_mask`` from
``pbe_tpu/data/masks.py``).

Convention: returned masks are (H, W, 1) float32 with **1 = edit region**;
the model-level keep mask is 1 - this.
"""
from __future__ import annotations

import numpy as np


def bbox_mask(h: int, w: int, bbox: tuple[float, float, float, float]) -> np.ndarray:
    """bbox (x1, y1, x2, y2) -> (H, W, 1) mask, 1 inside the box."""
    x1, y1, x2, y2 = bbox
    m = np.zeros((h, w), np.float32)
    m[int(round(y1)):int(round(y2)), int(round(x1)):int(round(x2))] = 1.0
    return m[..., None]
