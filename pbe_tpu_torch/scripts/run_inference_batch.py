"""Directory/batch inference CLI (port of ``scripts/run_inference_batch.py``).

    python -m pbe_tpu_torch.scripts.run_inference_batch \\
        --fpath_config configs/v1.yaml --fpath_checkpoint model.ckpt \\
        --image_dir DIR --mask_dir DIR --reference_dir DIR \\
        --outdir out [--use_plms] [--scale 5] [--ddim_steps 50]

mask_dir entries may be mask PNGs or bbox txt files ('x1 y1 x2 y2'). The
flags are the JAX CLI's, plus --device (default cuda; without a card and
without --device cpu it exits non-zero). --data_parallel is refused with a
non-zero exit: multi-card serving is not ported.
"""
from __future__ import annotations

import argparse

from pbe_tpu_torch.scripts.inference import device_and_dtype, refuse


def main(argv=None) -> int:
    """Run the CLI; returns the number of edits written."""
    p = argparse.ArgumentParser()
    p.add_argument("--fpath_config", default="configs/v1.yaml")
    p.add_argument("--fpath_checkpoint", default="")
    p.add_argument("--image_dir", required=True)
    p.add_argument("--mask_dir", required=True)
    p.add_argument("--reference_dir", required=True)
    p.add_argument("--outdir", default="outputs/batch")
    p.add_argument("--use_plms", action="store_true")
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--seed", type=int, default=321)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--precision", choices=["full", "autocast"], default="autocast")
    p.add_argument("--paste_back", type=int, default=None, metavar="FEATHER",
                   help="detail-preserving composite outside the mask "
                        "(feather px; omit for reference parity)")
    p.add_argument("--data_parallel", action="store_true",
                   help="not ported: multi-card serving (refused)")
    p.add_argument("--det_first_stage", action="store_true",
                   help="posterior-MODE masked-source latents")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    opt = p.parse_args(argv)
    if opt.data_parallel:
        refuse("--data_parallel", "multi-card serving (EditPipeline.shard)", "11")
    device, dtype = device_and_dtype(opt.device, opt.precision)

    from pbe_tpu_torch.pipelines.batch import infer_all
    from pbe_tpu_torch.pipelines.loading import load_pipeline

    pipeline, _ = load_pipeline(opt.fpath_config, opt.fpath_checkpoint or None,
                                device=device, dtype=dtype)
    n = infer_all(
        pipeline, opt.image_dir, opt.mask_dir, opt.reference_dir, opt.outdir,
        size=(opt.H, opt.W), batch_size=opt.batch_size,
        steps=opt.ddim_steps, scale=opt.scale,
        sampler="plms" if opt.use_plms else "ddim", seed=opt.seed,
        paste_back=opt.paste_back, det_first_stage=opt.det_first_stage,
    )
    print(f"wrote {n} edits to {opt.outdir}")
    return n


if __name__ == "__main__":
    main()
