"""COCOEE test-bench batch inference (port of
``scripts/inference_test_bench.py``): the pairs of --test_bench_dir in
batches of --n_samples, one result PNG (and one grid) per id, for the
evaluation tools.

    python -m pbe_tpu_torch.scripts.inference_test_bench --plms \\
        --outdir results/test_bench --config configs/v1.yaml --ckpt model.ckpt \\
        --test_bench_dir test_bench --n_samples 4 --scale 5 --seed 321

The flags are the JAX CLI's, plus --device (default cuda; without a card and
without --device cpu it exits non-zero). --quantize int8 runs the UNet's
eligible matmuls and convs in w8a8; int8-static first calibrates constant
scales on the first test-bench pair. Refused with a non-zero exit, as not
ported: --data_parallel (multi-card serving).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from pbe_tpu_torch.scripts.inference import device_and_dtype, refuse


def main(argv=None) -> dict:
    """Run the CLI; returns {"edits", "batches": [(pairs, seconds) of each
    infer_batch call], "wall_s", "steady_edits_per_s" (None with one
    batch)}."""
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", type=str, default="results/test_bench")
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--plms", action="store_true")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("--n_samples", type=int, default=4, help="batch size")
    p.add_argument("--config", type=str, default="configs/v1.yaml")
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--seed", type=int, default=321)
    p.add_argument("--precision", choices=["full", "autocast"], default="autocast")
    p.add_argument("--test_bench_dir", type=str, default="test_bench")
    p.add_argument("--limit", type=int, default=0, help="cap pairs (0 = all 3500)")
    p.add_argument("--skip_grid", action="store_true")
    p.add_argument("--paste_back", type=int, default=None, metavar="FEATHER",
                   help="detail-preserving composite outside the mask "
                        "(feather px; omit for reference parity)")
    p.add_argument("--data_parallel", action="store_true",
                   help="not ported: multi-card serving (refused)")
    p.add_argument("--uint8_out", action="store_true",
                   help="read results back as device-converted uint8 "
                        "(4x smaller readback; PNGs may differ by 1 LSB from "
                        "the float path on rounding boundaries)")
    p.add_argument("--det_first_stage", action="store_true",
                   help="posterior-MODE masked-source latents")
    p.add_argument("--quantize", choices=["int8", "int8-static"], default=None,
                   help="w8a8 int8 UNet execution, opt-in; the ragged last batch runs "
                        "at its own shape, whose int8 rounding may differ from the full "
                        "batch's. int8-static calibrates constant scales on the first "
                        "test-bench pair")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    opt = p.parse_args(argv)
    if opt.data_parallel:
        refuse("--data_parallel", "multi-card serving (EditPipeline.shard)", "11")
    device, dtype = device_and_dtype(opt.device, opt.precision)

    from PIL import Image

    from pbe_tpu_torch.data import transforms as T
    from pbe_tpu_torch.data.loader import DataLoader
    from pbe_tpu_torch.data.test_bench import COCOEEDataset
    from pbe_tpu_torch.pipelines.batch import infer_batch, visualize_batch
    from pbe_tpu_torch.pipelines.loading import load_pipeline
    from pbe_tpu_torch.utils.async_writer import AsyncWriter

    pipeline, _ = load_pipeline(opt.config, opt.ckpt or None, device=device, dtype=dtype,
                                quantize="int8" if opt.quantize else None)
    ds = COCOEEDataset(opt.test_bench_dir)
    if opt.quantize == "int8-static":
        ex = ds[0]  # real test-bench statistics for the PTQ scales
        pipeline.quant_scales = pipeline.calibrate_int8(
            ex["image"][None], ex["mask"][None], ex["ref"][None], seed=opt.seed)
        print(f"calibrated {len(pipeline.quant_scales)} static int8 op scales on the "
              "first test-bench pair", flush=True)
    if opt.limit:
        ds.ids = ds.ids[: opt.limit]
    dl = DataLoader(ds, opt.n_samples, shuffle=False, drop_last=False)

    result_dir = os.path.join(opt.outdir, "results")
    grid_dir = os.path.join(opt.outdir, "grid")
    os.makedirs(result_dir, exist_ok=True)

    def save_results(ids, preds, batch):
        u8 = preds.dtype == np.uint8
        for i, id_ in enumerate(ids):
            path = os.path.join(result_dir, f"{id_}.png")
            if u8:
                Image.fromarray(preds[i]).save(path)
            else:
                T.save_image(preds[i], path)
        if not opt.skip_grid:
            visualize_batch(batch, preds.astype(np.float32) / 255.0 if u8 else preds,
                            grid_dir, ids=ids)

    # PNG encode/save rides a bounded background queue, so the device does
    # not wait on host IO
    total, t_total, batches = 0, 0.0, []
    t_run = time.time()
    steady_t0, steady_n0, steady = None, 0, None
    with AsyncWriter(workers=2, max_queue=4) as writer:
        for batch in dl:
            t0 = time.time()
            preds = infer_batch(
                pipeline, batch, steps=opt.ddim_steps, scale=opt.scale,
                sampler="plms" if opt.plms else "ddim", eta=opt.ddim_eta,
                seed=opt.seed, paste_back=opt.paste_back,
                det_first_stage=opt.det_first_stage,
                output="uint8" if opt.uint8_out else "float32",
            )
            batches.append((len(preds), time.time() - t0))
            t_total += batches[-1][1]
            writer.submit(save_results, list(batch["id"]), preds, batch)
            total += len(preds)
            if steady_t0 is None:
                # steady-state wall rate (host decode/encode IO included)
                # starts after the first batch
                steady_t0, steady_n0 = time.time(), total
            print(f"{total}/{len(ds)} pairs, {total / max(t_total, 1e-9):.3f} edits/s "
                  f"in infer_batch", flush=True)

    wall = time.time() - t_run
    msg = (f"done: {total} edits in {wall:.1f}s wall / {t_total:.1f}s in infer_batch "
           f"({total / max(t_total, 1e-9):.3f} edits/s incl. the first batch) on {device}")
    if steady_t0 is not None and total > steady_n0:
        steady = (total - steady_n0) / max(time.time() - steady_t0, 1e-9)
        msg += f"; steady-state {steady:.3f} edits/s wall incl. host IO"
    print(msg)
    return {"edits": total, "batches": batches, "wall_s": wall, "steady_edits_per_s": steady}


if __name__ == "__main__":
    main()
