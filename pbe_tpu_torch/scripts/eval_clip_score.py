"""Region CLIP score CLI (port of ``scripts/eval_clip_score.py``; reference:
eval_tool/clip_score/region_clip_score.py).

    python -m pbe_tpu_torch.scripts.eval_clip_score \\
        --result_dir results/test_bench/results --test_bench_dir test_bench \\
        [--weights clip_vit_b32.pt] [--device cuda]

For each result: crop to the mask bbox, embed crop + exemplar with CLIP
ViT-B/32, cosine x100, mean over pairs. The flags are the JAX CLI's, plus
--device (default cuda; without a card and without --device cpu it exits
non-zero).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
from PIL import Image

from pbe_tpu_torch.scripts.inference import device_and_dtype


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--result_dir", required=True)
    p.add_argument("--test_bench_dir", default="test_bench")
    p.add_argument("--weights", default="", help="CLIP ViT-B/32 state_dict")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> float:
    """Run the CLI; returns the region CLIP score."""
    opt = get_parser().parse_args(argv)
    device, _ = device_and_dtype(opt.device, "autocast")

    from pbe_tpu_torch.data.test_bench import COCOEEDataset
    from pbe_tpu_torch.data.transforms import unnormalize_clip
    from pbe_tpu_torch.evaltools.clip_score import (VIT_B32, CLIPImageEmbedder,
                                                    region_clip_score)

    emb = (CLIPImageEmbedder.from_torch(opt.weights, device=device)
           if opt.weights else CLIPImageEmbedder(VIT_B32, device=device))
    if not opt.weights:
        print("WARNING: no --weights; CLIP is randomly initialized "
              "(score is not meaningful)", file=sys.stderr)

    ds = COCOEEDataset(opt.test_bench_dir)
    results, refs, masks = [], [], []
    for i in range(len(ds)):
        ex = ds[i]
        rp = os.path.join(opt.result_dir, f"{ex['id']}.png")
        if not os.path.exists(rp):
            continue
        results.append(np.asarray(Image.open(rp).convert("RGB"), np.float32) / 255.0)
        refs.append(np.clip(unnormalize_clip(ex["ref"]), 0, 1))
        masks.append(1.0 - ex["mask"])
    score = region_clip_score(emb, results, refs, masks, opt.batch_size)
    print(f"region CLIP score over {len(results)} pairs: {score:.4f}")
    return score


if __name__ == "__main__":
    main()
