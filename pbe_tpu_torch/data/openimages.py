"""Self-supervised Open-Images training dataset (port of
``pbe_tpu/data/openimages.py``; same tree and seed, bitwise-equal examples).

Re-derivation of the upstream OpenImageDataset (targeted by
configs/v1.yaml:80-84 with ``arbitrary_mask_percent: 0.5``; bbox txt files
as the reference's read_bbox.py writes them): each example is built from
one image + one object bbox, fully self-supervised:

  * mask  = the bbox, or (50%) a random Bézier blob around it
  * exemplar = the bbox crop, strongly augmented (flip/rotate/blur) to break
    the copy-paste shortcut
  * source = image with the mask region zeroed ("inpaint image")
  * target = the original image

Then a random square crop with 10-40% padding around the mask, resized to
``image_size`` (the fork's crop recipe, open-images.py:121-141). Randomness
comes from ``np.random.default_rng((seed, idx))``.

Layout on disk:
    <dataset_dir>/images/<state>/<id>.jpg
    <dataset_dir>/bbox/<state>/<id>.txt     (one 'x1 y1 x2 y2' line per box)

Returns the canonical batch dict of ``training.train_step``:
    {'image', 'inpaint_image', 'mask', 'ref'}  — mask is 1 = keep source.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image

from pbe_tpu_torch.data.augment import augment_exemplar
from pbe_tpu_torch.data.masks import geometry_bbox, mask_geometry, rasterize_geometry


def _resize_hwc(x: np.ndarray, size: int, nearest: bool = False) -> np.ndarray:
    mode = Image.NEAREST if nearest else Image.BICUBIC
    squeeze = x.shape[-1] == 1
    img = Image.fromarray(
        (np.clip((x[..., 0] if squeeze else x), 0, 1) * 255).astype(np.uint8)
    )
    out = np.asarray(img.resize((size, size), mode), np.float32) / 255.0
    return out[..., None] if squeeze else out


class OpenImagesDataset:
    """Map-style dataset; __getitem__(i) -> dict of float32 HWC arrays."""

    def __init__(
        self,
        dataset_dir: str,
        state: str = "train",
        image_size: int = 512,
        arbitrary_mask_percent: float = 0.5,
        min_box_frac: float = 0.02,
        max_box_frac: float = 0.8,
        seed: int = 0,
        uint8: bool = False,
    ):
        """uint8=True returns {'image','mask','ref'} as uint8 (mask 255 =
        keep, no 'inpaint_image' — it is image*mask, computed on the device
        by train_step's normalize_uint8_batch), which cuts the per-step
        host-to-device copy ~6.7x (63.5 -> 9.5 MB at batch 8)."""
        self.dataset_dir = Path(dataset_dir)
        self.state = state
        self.image_size = image_size
        self.arbitrary_mask_percent = arbitrary_mask_percent
        self.min_box_frac = min_box_frac
        self.max_box_frac = max_box_frac
        self.seed = seed
        self.uint8 = uint8
        bbox_dir = self.dataset_dir / "bbox" / state
        self.ids = sorted(p.stem for p in bbox_dir.glob("*.txt")) if bbox_dir.is_dir() else []

    def __len__(self) -> int:
        return len(self.ids)

    def _image_path(self, id_: str) -> Path:
        for ext in (".jpg", ".jpeg", ".png"):
            p = self.dataset_dir / "images" / self.state / f"{id_}{ext}"
            if p.exists():
                return p
        raise FileNotFoundError(f"no image for id {id_}")

    def _read_bboxes(self, id_: str) -> np.ndarray:
        p = self.dataset_dir / "bbox" / self.state / f"{id_}.txt"
        rows = []
        for line in p.read_text().strip().splitlines():
            vals = [float(v) for v in line.replace(",", " ").split()]
            if len(vals) >= 4:
                rows.append(vals[:4])
        return np.asarray(rows, np.float32)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        # Crop-first, uint8-first: instead of a full-res rasterize -> float
        # convert -> mask-multiply -> crop -> 3x float/PIL resize round trip,
        # the mask is generated as GEOMETRY, the crop window is computed from
        # that geometry, the image is cropped+resized once in uint8 (PIL
        # resize(box=...)), and the mask is rasterized directly in the
        # output frame — float conversion touches only image_size^2 pixels.
        rng = np.random.default_rng((self.seed, idx))
        id_ = self.ids[idx]
        img = Image.open(self._image_path(id_)).convert("RGB")
        w, h = img.size

        boxes = self._read_bboxes(id_)
        # filter degenerate boxes (area fraction bounds per read_bbox.py:35)
        if len(boxes):
            areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) / (w * h)
            keep = (areas > self.min_box_frac) & (areas < self.max_box_frac)
            boxes = boxes[keep]
        if len(boxes) == 0:
            # fall back to a central box
            boxes = np.asarray([[w * 0.25, h * 0.25, w * 0.75, h * 0.75]], np.float32)
        bbox = tuple(boxes[rng.integers(len(boxes))])

        geom = mask_geometry(h, w, bbox, rng, self.arbitrary_mask_percent)

        x1, y1, x2, y2 = (int(round(v)) for v in bbox)
        ref_crop = img.crop((max(x1, 0), max(y1, 0), min(x2, w), min(y2, h)))
        ref = augment_exemplar(ref_crop, rng, normalize=not self.uint8)

        # random square crop covering the EDIT region with 10-40% padding
        # (crop_square_around_mask math, computed from the geometry bbox —
        # cropping around the KEEP mask would degenerate to a max-square)
        gx1, gy1, gx2, gy2 = geometry_bbox(geom)
        side = int(max(gy2 - gy1, gx2 - gx1) * (1 + rng.uniform(0.10, 0.40)))
        side = max(min(side, h, w), 1)
        cy, cx = int(gy1 + gy2) // 2, int(gx1 + gx2) // 2
        top = max(min(cy - side // 2, h - side), 0)
        left = max(min(cx - side // 2, w - side), 0)

        s = self.image_size
        image_u8 = np.asarray(img.resize(
            (s, s), Image.BICUBIC, box=(left, top, left + side, top + side)))
        edit_u8 = rasterize_geometry(geom, s, s, left=left, top=top,
                                     scale=s / side)

        if self.uint8:
            return {
                "image": image_u8,
                "mask": np.where(edit_u8 > 127, 0, 255
                                 ).astype(np.uint8)[..., None],
                "ref": ref,
            }
        image = image_u8.astype(np.float32) / 255.0 * 2.0 - 1.0
        keep_mask = (edit_u8 <= 127).astype(np.float32)[..., None]
        return {
            "image": image,
            "inpaint_image": image * keep_mask,
            "mask": keep_mask,
            "ref": ref,
        }
