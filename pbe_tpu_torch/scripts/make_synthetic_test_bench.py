"""Write a synthetic COCOEE-layout test bench (port of
``scripts/make_synthetic_test_bench.py``: the same seed writes the same
pixels and the same ``id_list.npy``, byte for byte).

N (GT, Ref, Mask_bbox) triples in the disk layout of the reference test
bench (ldm/data/test_bench_dataset.py:61-105), which ``data/test_bench.py``
reads:

    <out>/id_list.npy
    <out>/GT_3500/<id:012>_GT.png           structured scenes
    <out>/Ref_3500/<id:012>_ref.png         exemplar = bbox crop of the GT
    <out>/Mask_bbox_3500/<id:012>_mask.png  white-in-edit-region bbox mask

The images are seeded smooth colour fields with geometric objects, not pure
noise, so the FID, CLIP-score and QS mechanics run on data with real
low-frequency statistics.

    python -m pbe_tpu_torch.scripts.make_synthetic_test_bench --n 512 --out DIR
"""
from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image


def _smooth_field(rng: np.random.Generator, size: int, low_res: int = 8) -> np.ndarray:
    """Low-frequency RGB background: bilinear-upsampled random grid, [0,1]."""
    grid = rng.uniform(0.1, 0.9, (low_res, low_res, 3)).astype(np.float32)
    img = Image.fromarray((grid * 255).astype(np.uint8))
    return np.asarray(img.resize((size, size), Image.BILINEAR), np.float32) / 255.0


def _draw_objects(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Stamp 3-6 solid ellipses/rectangles of random colour onto the scene."""
    size = img.shape[0]
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for _ in range(int(rng.integers(3, 7))):
        cx, cy = rng.uniform(0.1, 0.9, 2) * size
        rx, ry = rng.uniform(0.05, 0.2, 2) * size
        color = rng.uniform(0, 1, 3).astype(np.float32)
        if rng.uniform() < 0.5:
            inside = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0
        else:
            inside = (np.abs(xx - cx) <= rx) & (np.abs(yy - cy) <= ry)
        img = np.where(inside[..., None], color, img)
    return img


def make_pair(rng: np.random.Generator, size: int = 512):
    """-> (GT, ref, mask) in [0,1]: a scene, the 224^2 crop of its bbox, and
    the bbox as a white-is-edit mask covering ~4-25% of the image, like
    COCOEE's boxes."""
    gt = _draw_objects(rng, _smooth_field(rng, size))
    w = int(rng.uniform(0.2, 0.5) * size)
    h = int(rng.uniform(0.2, 0.5) * size)
    x0 = int(rng.uniform(0, size - w))
    y0 = int(rng.uniform(0, size - h))
    mask = np.zeros((size, size), np.float32)
    mask[y0:y0 + h, x0:x0 + w] = 1.0
    ref = gt[y0:y0 + h, x0:x0 + w]
    ref = np.asarray(Image.fromarray((ref * 255).astype(np.uint8)).resize(
        (224, 224), Image.BILINEAR), np.float32) / 255.0
    return gt, ref, mask


def write_bench(out: str, n: int = 512, size: int = 512, seed: int = 0) -> list[int]:
    """Write the bench to ``out`` -> its ids."""
    rng = np.random.default_rng(seed)
    for sub in ("GT_3500", "Ref_3500", "Mask_bbox_3500"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    ids = []
    for i in range(n):
        id_ = 100000 + i
        ids.append(id_)
        gt, ref, mask = make_pair(rng, size)
        Image.fromarray((gt * 255).astype(np.uint8)).save(
            os.path.join(out, "GT_3500", f"{id_:012d}_GT.png"))
        Image.fromarray((ref * 255).astype(np.uint8)).save(
            os.path.join(out, "Ref_3500", f"{id_:012d}_ref.png"))
        Image.fromarray((mask * 255).astype(np.uint8)).save(
            os.path.join(out, "Mask_bbox_3500", f"{id_:012d}_mask.png"))
        if (i + 1) % 100 == 0:
            print(f"{i + 1}/{n}", flush=True)
    np.save(os.path.join(out, "id_list.npy"), np.asarray(ids, np.int64))
    return ids


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--out", type=str, default="test_bench")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> list[int]:
    opt = get_parser().parse_args(argv)
    ids = write_bench(opt.out, opt.n, opt.size, opt.seed)
    print(f"wrote {opt.n} pairs to {opt.out}")
    return ids


if __name__ == "__main__":
    main()
