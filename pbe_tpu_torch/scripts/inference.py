"""Single-edit CLI (port of ``scripts/inference.py``): given --image_path,
--mask_path and --reference_path, repaint the masked region to depict the
exemplar and save results/, grid/ and source/ PNGs under --outdir with the
JAX CLI's file names.

    python -m pbe_tpu_torch.scripts.inference --outdir results \\
        --config configs/v1.yaml --ckpt model.ckpt --image_path IMG \\
        --mask_path MASK --reference_path REF --seed 321 --scale 5 [--plms]

The flags are the JAX CLI's, plus --device (default cuda; cpu runs the
kernels' plain versions). Without a card and without --device cpu it exits
non-zero. --precision full runs the model in fp32, on the card through the
fp32 attention kernels, with TF32 off for every product and convolution.
DDIM unless --plms; --n_iter loops the sampler with the seed advancing;
every result carries the invisible "Paint-by-Example" watermark unless
--no_watermark. --quantize int8 runs the UNet's eligible matmuls and convs in
w8a8; int8-static first calibrates constant scales on this edit's inputs.
--safety_ckpt screens every result with the safety checker (a diffusers
checkpoint; report-only unless --enforce_safety, which blacks out flagged
frames). --tile_ks/--tile_stride run every UNet call over latent crops
(ops/tiling.py).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", type=str, nargs="?", default="outputs/txt2img-samples",
                   help="dir to write results to")
    p.add_argument("--skip_grid", action="store_true",
                   help="do not save a grid, only individual samples")
    p.add_argument("--no_watermark", action="store_true",
                   help="skip the invisible 'Paint-by-Example' DWT-DCT watermark")
    p.add_argument("--skip_save", action="store_true",
                   help="do not save individual samples (speed measurements)")
    p.add_argument("--ddim_steps", type=int, default=50, help="number of sampling steps")
    p.add_argument("--plms", action="store_true", help="use plms sampling")
    p.add_argument("--fixed_code", action="store_true",
                   help="use the same starting code across samples")
    p.add_argument("--ddim_eta", type=float, default=0.0,
                   help="ddim eta (0.0 = deterministic sampling)")
    p.add_argument("--n_iter", type=int, default=2, help="sample this often")
    p.add_argument("--H", type=int, default=512, help="image height, pixels")
    p.add_argument("--W", type=int, default=512, help="image width, pixels")
    p.add_argument("--n_imgs", type=int, default=100, help="accepted and unused")
    p.add_argument("--C", type=int, default=4, help="latent channels")
    p.add_argument("--f", type=int, default=8, help="downsampling factor")
    p.add_argument("--n_samples", type=int, default=1,
                   help="samples per reference image (batch size)")
    p.add_argument("--n_rows", type=int, default=0,
                   help="rows in the grid (default: n_samples)")
    p.add_argument("--scale", type=float, default=1,
                   help="CFG scale: eps = eps(uc) + scale * (eps(c) - eps(uc))")
    p.add_argument("--config", type=str, default="",
                   help="path to config which constructs model")
    p.add_argument("--ckpt", type=str, default="",
                   help="path to checkpoint of model (reference .ckpt)")
    p.add_argument("--seed", type=int, default=42,
                   help="the seed (for reproducible sampling)")
    p.add_argument("--precision", type=str, choices=["full", "autocast"],
                   default="autocast", help="fp32 or bf16 inference")
    p.add_argument("--image_path", type=str, default="")
    p.add_argument("--mask_path", type=str, default="")
    p.add_argument("--reference_path", type=str, default="")
    p.add_argument("--paste_back", type=int, default=None, metavar="FEATHER",
                   help="composite original pixels outside the mask "
                        "(feather radius in px; omit for reference parity)")
    p.add_argument("--det_first_stage", action="store_true",
                   help="encode the masked source with the VAE posterior "
                        "MODE instead of sampling")
    p.add_argument("--safety_ckpt", type=str,
                   default=os.environ.get("PBE_SAFETY_CKPT", ""),
                   help="path to the CompVis stable-diffusion-safety-checker weights "
                        "(diffusers .bin/.pt/.ckpt/.safetensors); the check is "
                        "report-only unless --enforce_safety")
    p.add_argument("--quantize", choices=["int8", "int8-static"], default=None,
                   help="w8a8 int8 UNet execution (ops/quant.py), opt-in; int8-static "
                        "calibrates constant scales on this edit's inputs first")
    p.add_argument("--tile_ks", type=int, default=0,
                   help="tiled inference: latent tile size (0 = off); every UNet "
                        "call runs over overlapping latent crops, all in one batch")
    p.add_argument("--tile_stride", type=int, default=0,
                   help="latent tile stride (default ks/2 when --tile_ks is set)")
    p.add_argument("--enforce_safety", action="store_true",
                   help="black out frames the safety checker flags (default: "
                        "report only, as the reference); needs --safety_ckpt")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def refuse(flag: str, what: str, item: str) -> None:
    raise SystemExit(f"{flag}: {what} is not ported to pbe_tpu_torch yet "
                     f"(ROADMAP Queue 1, item {item})")


def device_and_dtype(device: str, precision: str) -> tuple[str, torch.dtype]:
    """The CLIs' device and model dtype. Exits non-zero for CUDA without a
    card (nothing falls back to the CPU). --precision full is fp32
    throughout: it turns TF32 off for matmuls and for cuDNN's convolutions,
    which would otherwise run fp32 convolutions in TF32 on the card, and
    says so."""
    dtype = torch.float32 if precision == "full" else torch.bfloat16
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("--precision full: fp32 model, TF32 off (torch.backends.cuda.matmul."
              "allow_tf32 = torch.backends.cudnn.allow_tf32 = False)")
    return device, dtype


def main(argv=None) -> list[float]:
    """Run the CLI; returns the seconds of each of the --n_iter edits."""
    opt = get_parser().parse_args(argv)
    tiling = None
    if opt.tile_ks:
        from pbe_tpu_torch.ops.tiling import TilingSpec

        stride = opt.tile_stride or max(opt.tile_ks // 2, 1)
        tiling = TilingSpec(ks=(opt.tile_ks, opt.tile_ks), stride=(stride, stride))
    elif opt.tile_stride:
        raise SystemExit(
            "--tile_stride has no effect without --tile_ks (tiling stays off and the "
            "stride would be silently ignored); pass --tile_ks to enable tiled inference")
    device, dtype = device_and_dtype(opt.device, opt.precision)

    from pbe_tpu_torch.data import transforms as T
    from pbe_tpu_torch.pipelines.loading import load_pipeline
    from pbe_tpu_torch.utils.watermark import embed_watermark

    config = opt.config or os.path.join(REPO, "configs", "v1.yaml")
    pipeline, _ = load_pipeline(config, opt.ckpt or None, device=device, dtype=dtype,
                                quantize="int8" if opt.quantize else None, tiling=tiling)

    safety = None
    if opt.safety_ckpt:
        from pbe_tpu_torch.models.safety import load_safety_checker

        safety = load_safety_checker(opt.safety_ckpt, device=device)

    sample_path = os.path.join(opt.outdir, "source")
    result_path = os.path.join(opt.outdir, "results")
    grid_path = os.path.join(opt.outdir, "grid")
    for d in (sample_path, result_path, grid_path):
        os.makedirs(d, exist_ok=True)

    stem = os.path.basename(opt.image_path)[:-4]
    size = (opt.H, opt.W)
    image = T.load_image(opt.image_path, size)
    mask = T.load_mask(opt.mask_path, size)
    ref = T.load_reference(opt.reference_path, pipeline.ref_size)

    b = opt.n_samples
    images = np.repeat(image[None], b, 0)
    masks = np.repeat(mask[None], b, 0)
    refs = np.repeat(ref[None], b, 0)

    x_T = None
    if opt.fixed_code:
        gen = torch.Generator().manual_seed(opt.seed)
        x_T = torch.randn((b, opt.H // opt.f, opt.W // opt.f, opt.C), generator=gen).numpy()

    if opt.quantize == "int8-static":
        # constant PTQ scales from this edit's own inputs
        pipeline.quant_scales = pipeline.calibrate_int8(images[:1], masks[:1], refs[:1],
                                                        seed=opt.seed)
        print(f"calibrated {len(pipeline.quant_scales)} static int8 op scales on the "
              "edit inputs")

    inpaint = T.unnormalize(images * masks)
    src01 = T.unnormalize(images)
    ref01 = np.clip(T.unnormalize_clip(refs), 0, 1)

    times = []
    for it in range(max(opt.n_iter, 1)):
        t0 = time.time()
        out = pipeline.edit_batch(
            images, masks, refs, steps=opt.ddim_steps, scale=opt.scale,
            sampler="plms" if opt.plms else "ddim", eta=opt.ddim_eta,
            seed=opt.seed + it,  # the draws advance across iterations
            x_T=x_T,  # --fixed_code pins the start noise across iterations
            paste_back=opt.paste_back, det_first_stage=opt.det_first_stage)
        times.append(time.time() - t0)
        if safety is not None:
            # the reference checks the decoded batch and discards the
            # verdict; it is applied only under --enforce_safety
            out, has_nsfw = safety.check(out, enforce=opt.enforce_safety)
            for i, flag in enumerate(has_nsfw):
                if flag:
                    action = ("blacked out" if opt.enforce_safety
                              else "report-only, kept (reference semantics)")
                    print(f"safety: sample {it * b + i} flagged NSFW — {action}")
        if opt.skip_save:
            continue
        for i in range(b):
            k = it * b + i  # global sample index
            base = f"{stem}_{opt.seed}" + (f"_{k}" if k else "")
            result = out[i]
            if not opt.no_watermark:
                u8 = np.clip(np.rint(result * 255.0), 0, 255).astype(np.uint8)
                result = embed_watermark(u8).astype(np.float32) / 255.0
            T.save_image(result, os.path.join(result_path, f"{base}.png"))
            if not opt.skip_grid:
                grid = T.hstack_grid([src01[i], inpaint[i], ref01[i], out[i]])
                T.save_image(grid, os.path.join(grid_path, f"grid-{base}.png"))
            if k == 0:
                # the inputs do not vary across samples; written once
                T.save_image(np.repeat(1.0 - masks[i], 3, axis=-1),
                             os.path.join(sample_path, f"{base}_mask.png"))
                T.save_image(src01[i], os.path.join(sample_path, f"{base}_GT.png"))
                T.save_image(inpaint[i], os.path.join(sample_path, f"{base}_inpaint.png"))
                T.save_image(ref01[i], os.path.join(sample_path, f"{base}_ref.png"))

    steady = times[1:] or times
    print(f"first call: {times[0]:.2f}s; steady-state edit: {np.mean(steady):.2f}s for "
          f"batch {b} ({np.mean(steady) / b:.3f}s/edit, {len(times)} iterations) on "
          f"{device}")
    print(f"Your samples are ready and waiting for you here: \n{opt.outdir}")
    return times


if __name__ == "__main__":
    main()
