"""Two-folder FID CLI (port of ``scripts/eval_fid.py``; reference:
eval_tool/fid/fid_score.py).

    python -m pbe_tpu_torch.scripts.eval_fid <dir1> <dir2> [--weights inception.pt]
        [--batch-size 50] [--clip-features [--clip-weights clip.pt]] [--device cuda]

With --weights, features come from a torchvision InceptionV3 state_dict;
--clip-features switches to the CLIP ViT-B/32 tower (bring weights too).
The flags are the JAX CLI's, plus --device (default cuda; without a card and
without --device cpu it exits non-zero).
"""
from __future__ import annotations

import argparse
import sys

from pbe_tpu_torch.scripts.inference import device_and_dtype


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("paths", nargs=2)
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--weights", type=str, default="",
                   help="torchvision InceptionV3 state_dict (.pt/.pth)")
    p.add_argument("--clip-features", action="store_true",
                   help="use CLIP ViT-B/32 features instead of Inception")
    p.add_argument("--clip-weights", type=str, default="")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> float:
    """Run the CLI; returns the FID."""
    opt = get_parser().parse_args(argv)
    device, _ = device_and_dtype(opt.device, "autocast")

    from pbe_tpu_torch.evaltools.fid import fid_between_dirs, make_inception_feature_fn

    if opt.clip_features:
        from pbe_tpu_torch.evaltools.clip_score import VIT_B32, CLIPImageEmbedder

        emb = (CLIPImageEmbedder.from_torch(opt.clip_weights, device=device)
               if opt.clip_weights else CLIPImageEmbedder(VIT_B32, device=device))
        feature_fn, size = emb, 224
    else:
        if not opt.weights:
            print("WARNING: no --weights; Inception is randomly initialized "
                  "(FID value is not meaningful)", file=sys.stderr)
        feature_fn = make_inception_feature_fn(opt.weights or None, device=device)
        size = 299

    fid = fid_between_dirs(
        opt.paths[0], opt.paths[1], feature_fn,
        batch_size=opt.batch_size, size=size,
    )
    print(f"FID: {fid:.4f}")
    return fid


if __name__ == "__main__":
    main()
