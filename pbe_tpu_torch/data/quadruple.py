"""CSV-driven (target, source, mask, reference) quadruple dataset (port of
``pbe_tpu/data/quadruple.py``).

Working equivalent of the fork's import-broken PBEQuadrupleDataset
(ldm/data/open-images.py:146-192): a CSV with columns tgt,src,mask,ref of
file paths; source is masked, cropped to a random square around the mask
(pad 10-40%), resized; the exemplar gets the strong CLIP-side augmentation.
"""
from __future__ import annotations

import csv

import numpy as np
from PIL import Image

from pbe_tpu_torch.data.augment import augment_exemplar, clip_preprocess
from pbe_tpu_torch.data.masks import crop_square_around_mask
from pbe_tpu_torch.data.openimages import _resize_hwc


class QuadrupleDataset:
    def __init__(
        self,
        csv_file: str,
        image_size: int = 512,
        crop_to_square: bool = True,
        seed: int = 0,
        augment: bool = True,
    ):
        with open(csv_file) as f:
            self.rows = list(csv.DictReader(f))
        for col in ("tgt", "src", "mask", "ref"):
            if self.rows and col not in self.rows[0]:
                raise ValueError(f"CSV must have a {col!r} column")
        self.image_size = image_size
        self.crop = crop_to_square
        self.seed = seed
        self.augment = augment

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, idx))
        row = self.rows[idx]
        tgt = np.asarray(Image.open(row["tgt"]).convert("RGB"), np.float32) / 255.0
        src = np.asarray(Image.open(row["src"]).convert("RGB"), np.float32) / 255.0
        m = np.asarray(Image.open(row["mask"]).convert("L"), np.float32) / 255.0
        keep = (m >= 0.5).astype(np.float32)[..., None]  # white = keep source

        tgt = tgt * 2 - 1
        src = src * 2 - 1
        if self.crop:
            # crop centers on the EDIT region (1 - keep), not the keep mask
            tgt, src, edit = crop_square_around_mask(tgt, src, 1.0 - keep, rng)
            keep = 1.0 - edit

        s = self.image_size
        tgt = _resize_hwc((tgt + 1) / 2, s) * 2 - 1
        src = _resize_hwc((src + 1) / 2, s) * 2 - 1
        keep = (_resize_hwc(keep, s) > 0.5).astype(np.float32)
        inpaint = src * keep

        ref_img = Image.open(row["ref"]).convert("RGB")
        ref = augment_exemplar(ref_img, rng) if self.augment else clip_preprocess(ref_img)

        return {
            "image": tgt.astype(np.float32),
            "source": src.astype(np.float32),
            "inpaint_image": inpaint.astype(np.float32),
            "mask": keep,
            "ref": ref,
        }
