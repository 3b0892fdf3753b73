"""Host-side image IO and preprocessing (numpy/PIL), NHWC: the port's own
copy of ``pbe_tpu/data/transforms.py``.

Replaces the torchvision transform stack of the reference CLI
(scripts/inference.py:36-44,106-124,305-318):
  * source image -> [-1,1] float32
  * mask (L) -> inverted, binarized at 0.5 (1 = keep source pixel)
  * reference/exemplar -> 224x224, CLIP-normalized

All functions return numpy arrays; the pipeline moves them to its device.
"""
from __future__ import annotations

import numpy as np
from PIL import Image

from pbe_tpu_torch.ops.image import CLIP_MEAN, CLIP_STD


def unpack_uint8_batch(batch: dict) -> dict:
    """Host-side inverse of the uint8 transfer format
    (OpenImagesDataset(uint8=True)) for consumers that need float
    batches on the host (trainer sampling/FID). No-op for float batches."""
    img = batch.get("image")
    if img is None or getattr(img, "dtype", None) != np.uint8:
        return batch
    image = img.astype(np.float32) / 255.0 * 2.0 - 1.0
    mask = (np.asarray(batch["mask"]) > 127).astype(np.float32)
    ref = (batch["ref"].astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
    out = {k: v for k, v in batch.items() if k not in ("image", "mask", "ref")}
    out.update(image=image, inpaint_image=image * mask, mask=mask,
               ref=ref.astype(np.float32))
    return out


def load_image(path: str, size: tuple[int, int] | None = None) -> np.ndarray:
    """RGB image -> (H, W, 3) float32 in [-1, 1]."""
    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize((size[1], size[0]), Image.BICUBIC)
    x = np.asarray(img, np.float32) / 255.0
    return x * 2.0 - 1.0


def load_mask(path: str, size: tuple[int, int] | None = None) -> np.ndarray:
    """L mask -> (H, W, 1) float32 in {0,1}; input white = edit region, output
    1 = keep source (inverted + binarized, scripts/inference.py:312-316)."""
    img = Image.open(path).convert("L")
    if size is not None:
        img = img.resize((size[1], size[0]), Image.NEAREST)
    m = 1.0 - np.asarray(img, np.float32) / 255.0
    m = np.where(m < 0.5, 0.0, 1.0).astype(np.float32)
    return m[..., None]


def load_reference(path: str, size: int = 224) -> np.ndarray:
    """Exemplar -> (size, size, 3) float32, CLIP-normalized."""
    img = Image.open(path).convert("RGB").resize((size, size), Image.BICUBIC)
    x = np.asarray(img, np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD


def to_uint8(img01: np.ndarray) -> np.ndarray:
    return (np.clip(img01, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def unnormalize(x: np.ndarray) -> np.ndarray:
    return (x + 1.0) / 2.0


def unnormalize_clip(x: np.ndarray) -> np.ndarray:
    return x * CLIP_STD + CLIP_MEAN


def save_image(img01: np.ndarray, path: str) -> None:
    Image.fromarray(to_uint8(img01)).save(path)


def hstack_grid(images01: list[np.ndarray], pad: int = 2) -> np.ndarray:
    """Simple horizontal grid of same-height [0,1] HWC images."""
    h = max(im.shape[0] for im in images01)
    cols = []
    for im in images01:
        if im.shape[0] != h:
            im = np.asarray(
                Image.fromarray(to_uint8(im)).resize(
                    (int(im.shape[1] * h / im.shape[0]), h), Image.BICUBIC
                ),
                np.float32,
            ) / 255.0
        cols.append(im)
        cols.append(np.ones((h, pad, 3), np.float32))
    return np.concatenate(cols[:-1], axis=1)
