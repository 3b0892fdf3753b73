"""Open-Images annotation prep (port of ``scripts/read_bbox.py``; reference:
scripts/read_bbox.py:1-54): from the same CSV and images it writes the same
bbox files.

Converts Open-Images bbox CSV annotations into per-image txt files of pixel
bboxes, dropping boxes that cover more than 80% or less than 2% of the
image, laid out as ``data/openimages.py`` expects:

    python -m pbe_tpu_torch.scripts.read_bbox --csv oidv6-train-annotations-bbox.csv \\
        --image_dir dataset/open-images/images/train \\
        --out_dir dataset/open-images/bbox/train

CSV columns used: ImageID, XMin, XMax, YMin, YMax (normalized to [0,1]).
"""
from __future__ import annotations

import argparse
import csv
import os
from collections import defaultdict

from PIL import Image


def main(argv=None) -> int:
    """Run the CLI; returns the number of images given a bbox file."""
    p = argparse.ArgumentParser()
    p.add_argument("--csv", required=True)
    p.add_argument("--image_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--min_area_frac", type=float, default=0.02)
    p.add_argument("--max_area_frac", type=float, default=0.8)
    opt = p.parse_args(argv)

    boxes = defaultdict(list)
    with open(opt.csv) as f:
        for row in csv.DictReader(f):
            boxes[row["ImageID"]].append((float(row["XMin"]), float(row["YMin"]),
                                          float(row["XMax"]), float(row["YMax"])))

    os.makedirs(opt.out_dir, exist_ok=True)
    written = 0
    for image_id, blist in boxes.items():
        img_path = next((c for ext in (".jpg", ".jpeg", ".png")
                         if os.path.exists(c := os.path.join(opt.image_dir, image_id + ext))),
                        None)
        if img_path is None:
            continue
        with Image.open(img_path) as img:
            w, h = img.size
        lines = [f"{x1 * w:.1f} {y1 * h:.1f} {x2 * w:.1f} {y2 * h:.1f}"
                 for x1, y1, x2, y2 in blist
                 if opt.min_area_frac < (x2 - x1) * (y2 - y1) < opt.max_area_frac]
        if lines:
            with open(os.path.join(opt.out_dir, image_id + ".txt"), "w") as f:
                f.write("\n".join(lines) + "\n")
            written += 1
    print(f"wrote bbox files for {written} images to {opt.out_dir}")
    return written


if __name__ == "__main__":
    main()
