"""COCOEE 3500-pair test bench dataset (the port's own copy of
``pbe_tpu/data/test_bench.py``).

Disk layout + semantics per the reference COCOImageDataset
(ldm/data/test_bench_dataset.py:61-105):
    <test_bench_dir>/id_list.npy
    <test_bench_dir>/GT_3500/<id:012>_GT.png
    <test_bench_dir>/Ref_3500/<id:012>_ref.png
    <test_bench_dir>/Mask_bbox_3500/<id:012>_mask.png
Mask PNGs are white-in-the-edit-region; the keep mask is their inverse.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image

from pbe_tpu_torch.data.augment import clip_preprocess


class COCOEEDataset:
    def __init__(self, test_bench_dir: str):
        self.dir = Path(test_bench_dir)
        self.ids = [int(i) for i in np.load(self.dir / "id_list.npy").tolist()]

    def __len__(self) -> int:
        return len(self.ids)

    def _p(self, sub: str, id_: int, suffix: str) -> Path:
        return self.dir / sub / f"{id_:012d}_{suffix}.png"

    def __getitem__(self, idx: int) -> dict:
        id_ = self.ids[idx]
        img = Image.open(self._p("GT_3500", id_, "GT")).convert("RGB")
        image = np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0
        ref = clip_preprocess(
            Image.open(self._p("Ref_3500", id_, "ref")).convert("RGB")
        )
        m = np.asarray(
            Image.open(self._p("Mask_bbox_3500", id_, "mask")).convert("L"),
            np.float32,
        ) / 255.0
        keep = (1.0 - m >= 0.5).astype(np.float32)[..., None]
        return {
            "image": image.astype(np.float32),
            "inpaint_image": (image * keep).astype(np.float32),
            "mask": keep,
            "ref": ref,
            "id": f"{id_:012d}",
        }
