"""QS (GMM) score CLI (port of ``scripts/eval_gmm.py``; reference:
eval_tool/gmm/gmm_score_coco.py).

    python -m pbe_tpu_torch.scripts.eval_gmm <dir> --gmm gmm.pkl [--pca pca.pkl]
        [--weights inception.pt] [--output_file scores.txt] [--device cuda]

The GMM's log-likelihood is computed in float64 on the device from the
pickle's fitted attributes (evaltools/gmm_score.py): scoring needs no
sklearn, though unpickling an sklearn model does. The flags are the JAX
CLI's, plus --device (default cuda; without a card and without --device cpu
it exits non-zero).
"""
from __future__ import annotations

import argparse

import numpy as np
from PIL import Image

from pbe_tpu_torch.scripts.inference import device_and_dtype


def main(argv=None) -> float:
    """Run the CLI; returns the QS score."""
    p = argparse.ArgumentParser()
    p.add_argument("path")
    p.add_argument("--gmm", required=True, help="pretrained sklearn GMM pickle")
    p.add_argument("--pca", default="", help="optional PCA pickle")
    p.add_argument("--weights", default="", help="Inception state_dict")
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--output_file", default="")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    opt = p.parse_args(argv)
    device, _ = device_and_dtype(opt.device, "autocast")

    from pbe_tpu_torch.evaltools.fid import list_images, make_inception_feature_fn
    from pbe_tpu_torch.evaltools.gmm_score import gmm_score, load_gmm

    feature_fn = make_inception_feature_fn(opt.weights or None, device=device)
    gmm = load_gmm(opt.gmm)
    pca = load_gmm(opt.pca) if opt.pca else None

    files = list_images(opt.path)
    images = [
        np.asarray(
            Image.open(f).convert("RGB").resize((299, 299), Image.BILINEAR),
            np.float32,
        ) / 255.0
        for f in files
    ]
    score = gmm_score(feature_fn, images, gmm, pca, opt.batch_size, device=device)
    if opt.output_file:
        with open(opt.output_file, "w") as f:
            f.write(f"{score}\n")
    print(f"QS score of this folder is: {score:.4f}")
    return score


if __name__ == "__main__":
    main()
