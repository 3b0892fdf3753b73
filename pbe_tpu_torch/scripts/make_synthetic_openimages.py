"""Write a synthetic OpenImages-style training tree (port of
``scripts/make_synthetic_openimages.py``: the same tree from the same seed).

The layout ``data/openimages.py`` reads:

    <out>/images/<state>/<id>.png      random scenes with a coloured object
    <out>/bbox/<state>/<id>.txt        one 'x1 y1 x2 y2' line per box

It lets the train CLI run without the real corpus, and the input pipeline
(PNG decode, mask synthesis, host-to-device copies) be measured against a
real filesystem.

    python -m pbe_tpu_torch.scripts.make_synthetic_openimages --out DIR \\
        --n_train 64 --n_val 8 --size 512
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def make_tree(out: str, n_train: int = 64, n_val: int = 8, size: int = 512,
              seed: int = 0) -> None:
    from PIL import Image

    rng = np.random.default_rng(seed)
    for state, n in (("train", n_train), ("validation", n_val)):
        img_dir = os.path.join(out, "images", state)
        box_dir = os.path.join(out, "bbox", state)
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(box_dir, exist_ok=True)
        for i in range(n):
            # a textured background (PNG-compresses like a photo, not a
            # flat fill, so decoding costs what a photo's does) + one solid
            # object
            img = rng.integers(0, 256, (size, size, 3), np.uint8)
            w = int(rng.integers(size // 8, size // 3))
            h = int(rng.integers(size // 8, size // 3))
            x1 = int(rng.integers(0, size - w))
            y1 = int(rng.integers(0, size - h))
            img[y1:y1 + h, x1:x1 + w] = rng.integers(0, 256, 3, np.uint8)
            id_ = f"syn{i:06d}"
            Image.fromarray(img).save(os.path.join(img_dir, f"{id_}.png"))
            with open(os.path.join(box_dir, f"{id_}.txt"), "w") as f:
                f.write(f"{x1} {y1} {x1 + w} {y1 + h}\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--n_train", type=int, default=64)
    p.add_argument("--n_val", type=int, default=8)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    opt = p.parse_args(argv)
    make_tree(opt.out, opt.n_train, opt.n_val, opt.size, opt.seed)
    print(f"wrote {opt.n_train}+{opt.n_val} examples under {opt.out}")


if __name__ == "__main__":
    main()
