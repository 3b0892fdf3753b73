"""Freeze one edit configuration into a deployable artifact directory (port
of ``scripts/export_program.py``, its flags plus ``--device``).

Writes <outdir>/{prologue,step,epilogue}.pt2 (``torch.export`` programs,
no parameter inside), <outdir>/params.npz (the parameters by their
reference state_dict keys, pickle-free) and <outdir>/manifest.json, and
prints the manifest. A serving host then needs torch, numpy and
``pbe_tpu_torch/export_runtime.py`` only:

    from pbe_tpu_torch.export_runtime import load_edit_program_dir, load_params_npz
    fn = load_edit_program_dir("artifact")
    params = load_params_npz("artifact/params.npz")
    img01 = fn(params, image, mask, ref, x_T, scale)   # + eps_first_stage, noise

    python -m pbe_tpu_torch.scripts.export_program --outdir artifact
    python -m pbe_tpu_torch.scripts.export_program --outdir artifact --device cpu \\
        --precision full --config configs/tiny.yaml --H 64 --W 64 --ddim_steps 4

It runs on the card unless ``--device cpu`` is given; an artifact runs on
the device it was exported on.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from pbe_tpu_torch.scripts.inference import REPO, device_and_dtype, refuse


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--config", type=str, default="")
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--plms", action="store_true", default=True)
    p.add_argument("--ddim", dest="plms", action="store_false")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--scale", type=float, default=5.0,
                   help="only CFG-vs-not is baked in (scale stays a runtime argument); "
                        "scale=1 freezes the no-CFG fast path")
    p.add_argument("--paste_back", type=int, default=None, metavar="FEATHER")
    p.add_argument("--det_first_stage", action="store_true")
    p.add_argument("--precision", choices=["full", "autocast"], default="autocast")
    p.add_argument("--skip_params", action="store_true",
                   help="write only the programs (params ship separately)")
    p.add_argument("--quantize", choices=["int8", "int8-static"], default=None,
                   help="freeze the w8a8 program (ops/quant.py); int8-static calibrates "
                        "constant scales on a synthetic edit at the export geometry "
                        "first (the scales ship inside the programs)")
    p.add_argument("--data_parallel", action="store_true",
                   help="a partitioned program over every card (not ported)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns the manifest."""
    opt = get_parser().parse_args(argv)
    if opt.data_parallel:
        refuse("--data_parallel", "a program sharded over several cards", "11")
    device, dtype = device_and_dtype(opt.device, opt.precision)

    import numpy as np
    import torch

    from pbe_tpu_torch.export_runtime import save_params_npz
    from pbe_tpu_torch.pipelines.export import export_edit_program, save_edit_program
    from pbe_tpu_torch.pipelines.loading import load_pipeline

    config = opt.config or os.path.join(REPO, "configs", "v1.yaml")
    pipeline, _ = load_pipeline(config, opt.ckpt or None, device=device, dtype=dtype,
                                quantize="int8" if opt.quantize else None)
    if opt.quantize == "int8-static":
        g = np.random.default_rng(0)
        ci = g.uniform(-1, 1, (1, opt.H, opt.W, 3)).astype(np.float32)
        cm = np.ones((1, opt.H, opt.W, 1), np.float32)
        cm[:, opt.H // 4: 3 * opt.H // 4, opt.W // 4: 3 * opt.W // 4] = 0.0
        r = pipeline.ref_size
        cr = g.standard_normal((1, r, r, 3)).astype(np.float32)
        pipeline.quant_scales = pipeline.calibrate_int8(ci, cm, cr)
        print(f"calibrated {len(pipeline.quant_scales)} static int8 op scales",
              file=sys.stderr)

    program = export_edit_program(
        pipeline, batch=opt.batch, height=opt.H, width=opt.W, steps=opt.ddim_steps,
        sampler="plms" if opt.plms else "ddim", eta=opt.ddim_eta, cfg=opt.scale != 1.0,
        paste_back=opt.paste_back, det_first_stage=opt.det_first_stage)
    manifest = save_edit_program(opt.outdir, program)
    if not opt.skip_params:
        with torch.no_grad():
            save_params_npz(os.path.join(opt.outdir, "params.npz"),
                            pipeline.model.state_dict())
    manifest.update(config=config, ckpt=opt.ckpt or "RANDOM INIT", quantize=opt.quantize)
    with open(os.path.join(opt.outdir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    print(json.dumps({k: v for k, v in manifest.items() if k != "params"}))
    return manifest


if __name__ == "__main__":
    main()
