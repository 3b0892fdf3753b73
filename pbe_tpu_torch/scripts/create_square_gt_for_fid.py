"""COCO test2017 -> 512^2 center-crop GT set for FID (port of
``scripts/create_square_gt_for_fid.py``; reference:
scripts/create_square_gt_for_fid.py:1-12).

    python -m pbe_tpu_torch.scripts.create_square_gt_for_fid <coco_test2017_dir> <out_dir>
"""
from __future__ import annotations

import os
import sys

from PIL import Image


def main(argv=None) -> int:
    """Run the CLI; returns the number of images written."""
    src, dst = (sys.argv[1:] if argv is None else argv)[:2]
    os.makedirs(dst, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(src)):
        if not name.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        img = Image.open(os.path.join(src, name)).convert("RGB")
        w, h = img.size
        side = min(w, h)
        left, top = (w - side) // 2, (h - side) // 2
        img = img.crop((left, top, left + side, top + side)).resize(
            (512, 512), Image.BICUBIC
        )
        img.save(os.path.join(dst, os.path.splitext(name)[0] + ".png"))
        n += 1
    print(f"wrote {n} square GT images to {dst}")
    return n


if __name__ == "__main__":
    main()
