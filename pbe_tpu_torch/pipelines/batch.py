"""Batch inference API (port of ``pbe_tpu/pipelines/batch.py``).

Public-surface equivalent of the reference's r4_run_inference_batch.py:
  * infer_batch   (:342-411) — pure array-in/array-out batched edit
  * visualize_batch (:414-476) — 6-panel per-example grids
    [before | mask | inpaint | ref | GT | pred] + per-example files
  * run_batch     (:479-482) — infer + visualize
  * infer_all / infer_one (:332,:118) — directory walking over
    (image, mask-or-bbox-txt, reference) triples
  * load_mask_from_image_or_txt (:257-290) — accept either a mask PNG or a
    bbox txt ('x1 y1 x2 y2') rasterized to a mask
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from pbe_tpu_torch.data import transforms as T
from pbe_tpu_torch.data.masks import bbox_mask
from pbe_tpu_torch.pipelines.inference import EditPipeline
from pbe_tpu_torch.utils.async_writer import AsyncWriter


def infer_batch(
    pipeline: EditPipeline,
    batch: dict,
    *,
    steps: int = 50,
    scale: float = 5.0,
    sampler: str = "plms",
    eta: float = 0.0,
    seed: int = 42,
    paste_back: int | None = None,
    det_first_stage: bool = False,
    output: str = "float32",
) -> np.ndarray:
    """batch: {'image','inpaint_image','mask','ref'} NHWC arrays (the
    canonical dict every dataset yields). Returns predictions (B,H,W,3)
    float32 in [0,1] (uint8 in [0,255] with output="uint8" — converted on
    the device, 4x smaller readback)."""
    return pipeline.edit_batch(
        np.asarray(batch["image"]), np.asarray(batch["mask"]),
        np.asarray(batch["ref"]),
        steps=steps, scale=scale, sampler=sampler, eta=eta, seed=seed,
        paste_back=paste_back, det_first_stage=det_first_stage,
        output=output,
    )


def visualize_batch(
    batch: dict,
    preds: np.ndarray,
    outdir: str,
    ids: list[str] | None = None,
    do_save: bool = True,
) -> list[np.ndarray]:
    """Build (and optionally save) the 6-panel grids.

    Panel order matches r4_run_inference_batch.py:446-475:
    [before | mask | inpaint | ref | GT | pred]. 'before' is the source
    image (batch['source'] when the dataset distinguishes source from
    target, e.g. QuadrupleDataset); 'GT' is always batch['image'] (the
    target). When no 'source' key exists the two coincide by construction.
    """
    os.makedirs(outdir, exist_ok=True)
    image01 = T.unnormalize(np.asarray(batch["image"]))
    source01 = (
        T.unnormalize(np.asarray(batch["source"]))
        if "source" in batch else image01
    )
    inpaint01 = T.unnormalize(np.asarray(batch["inpaint_image"]))
    mask01 = np.repeat(np.asarray(batch["mask"]), 3, axis=-1)
    ref01 = np.clip(T.unnormalize_clip(np.asarray(batch["ref"])), 0, 1)
    grids = []
    for i in range(len(preds)):
        panels = [source01[i], 1.0 - mask01[i], inpaint01[i], ref01[i],
                  image01[i], preds[i]]
        grid = T.hstack_grid(panels)
        grids.append(grid)
        if do_save:
            name = ids[i] if ids else f"{i:06d}"
            T.save_image(grid, os.path.join(outdir, f"grid_{name}.png"))
            T.save_image(preds[i], os.path.join(outdir, f"pred_{name}.png"))
    return grids


def run_batch(pipeline: EditPipeline, batch: dict, outdir: str,
              writer=None, **kw) -> np.ndarray:
    """infer + visualize; pass an AsyncWriter to move the grid/PNG saves
    onto its background queue (device keeps running while the host
    encodes)."""
    preds = infer_batch(pipeline, batch, **kw)
    if writer is None:
        visualize_batch(batch, preds, outdir, ids=batch.get("id"))
    else:
        writer.submit(visualize_batch, dict(batch), preds, outdir,
                      ids=batch.get("id"))
    return preds


def load_mask_from_image_or_txt(
    path: str, hw: tuple[int, int]
) -> np.ndarray:
    """Mask PNG (white = edit region) or bbox txt -> (H,W,1) keep-mask."""
    if path.endswith(".txt"):
        vals = [float(v) for v in Path(path).read_text().split()[:4]]
        edit = bbox_mask(hw[0], hw[1], tuple(vals))
        return 1.0 - edit
    return T.load_mask(path, hw)


def infer_one(
    pipeline: EditPipeline,
    image_path: str,
    mask_path: str,
    reference_path: str,
    outdir: str,
    size: tuple[int, int] = (512, 512),
    **kw,
) -> np.ndarray:
    image = T.load_image(image_path, size)
    mask = load_mask_from_image_or_txt(mask_path, size)
    ref = T.load_reference(reference_path)
    batch = {
        "image": image[None], "inpaint_image": (image * mask)[None],
        "mask": mask[None], "ref": ref[None],
        "id": [Path(image_path).stem],
    }
    return run_batch(pipeline, batch, outdir, **kw)


def infer_all(
    pipeline: EditPipeline,
    image_dir: str,
    mask_dir: str,
    reference_dir: str,
    outdir: str,
    size: tuple[int, int] = (512, 512),
    batch_size: int = 4,
    **kw,
) -> int:
    """Walk parallel directories of (image, mask, reference) triples matched
    by stem; returns the number of edits produced. Saves run on a bounded
    background writer so host PNG encode overlaps device compute."""
    images = sorted(Path(image_dir).iterdir())
    n = 0
    batch_items: list[dict] = []

    with AsyncWriter(workers=2, max_queue=4) as writer:

        def flush():
            nonlocal n
            if not batch_items:
                return
            batch = {
                k: np.stack([b[k] for b in batch_items])
                for k in ("image", "inpaint_image", "mask", "ref")
            }
            batch["id"] = [b["id"] for b in batch_items]
            run_batch(pipeline, batch, outdir, writer=writer, **kw)
            n += len(batch_items)
            batch_items.clear()

        for img_path in images:
            stem = img_path.stem
            mask_path = _find(mask_dir, stem)
            ref_path = _find(reference_dir, stem)
            if mask_path is None or ref_path is None:
                continue
            image = T.load_image(str(img_path), size)
            mask = load_mask_from_image_or_txt(str(mask_path), size)
            batch_items.append({
                "image": image, "inpaint_image": image * mask, "mask": mask,
                "ref": T.load_reference(str(ref_path)), "id": stem,
            })
            if len(batch_items) == batch_size:
                flush()
        flush()
    return n


def _find(dir_: str, stem: str) -> Path | None:
    for ext in (".png", ".jpg", ".jpeg", ".txt"):
        p = Path(dir_) / f"{stem}{ext}"
        if p.exists():
            return p
    return None
