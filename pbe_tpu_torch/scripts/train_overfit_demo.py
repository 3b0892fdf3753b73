"""Overfit-to-visible-result training demo (port of
``scripts/train_overfit_demo.py``).

Trains the full v1-geometry model on 8 fixed synthetic (image, mask, ref)
pairs until sampled edits reproduce the memorized masked content: it
exercises the data path, loss, optimizer, sampler and decode together
(reference training semantics: latent_diffusion.py:617-634, 763-809).

The 8 scenes each place a distinct saturated shape on a structured
background; the exemplar is the CLIP-normalized crop of the masked region
(what the production loader feeds). After training, 50-step DDIM samples at
CFG scales 1 and 5 give ``overfit_summary.json`` (the latent rel-MSE of the
sampled z against the scene's VAE latent, and the PSNR of its decode
against the VAE round trip), 6-panel grids, side-by-side PNGs,
``loss_curve.json`` and, where matplotlib imports, ``loss_curve.png``.

    python -m pbe_tpu_torch.scripts.train_overfit_demo --steps 2000 --batch 8 \\
        --outdir overfit_demo [--config configs/v1.yaml] [--size 512] \\
        [--device cuda] [--precision autocast|full]

The flags are the JAX script's, plus --config and --size (the JAX script
fixes v1 and 512^2; a small config and size give a quick run) and --device
and --precision as the other CLIs take them. bf16 by default, remat on, a
constant LR, the VAE posterior's mode unless --sample_posterior. The card's
step time at v1 is in PERF.md (``chip_smoke.py`` phase 27).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from pbe_tpu_torch.scripts.inference import device_and_dtype


def make_pairs(n: int = 8, size: int = 512, seed: int = 7):
    """n deterministic scenes: structured background + a unique coloured
    shape inside a centred square mask; ref = CLIP-preprocessed crop of
    the masked region (what QuadrupleDataset feeds, open-images.py).
    -> (images [-1,1], masks (1 = keep), refs), NHWC float32."""
    from PIL import Image

    from pbe_tpu_torch.data.augment import clip_preprocess

    g = np.random.default_rng(seed)
    images, masks, refs = [], [], []
    q = size // 4
    for i in range(n):
        # background: smooth colour gradient + stripes, unique per scene
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        base = np.stack([
            0.3 + 0.4 * np.sin(2 * np.pi * (xx * (i % 3 + 1))),
            0.3 + 0.4 * np.cos(2 * np.pi * (yy * (i % 4 + 1))),
            0.5 + 0.3 * np.sin(2 * np.pi * (xx + yy) * (i % 2 + 1)),
        ], -1)
        img = base.copy()
        # shape in the centre quarter: filled disk or square, saturated colour
        color = np.eye(3)[i % 3] * 0.9 + 0.1
        cy, cx = size // 2, size // 2
        r = q // 2 - 8 * (i % 3)
        if i % 2 == 0:
            sel = (yy * size - cy) ** 2 + (xx * size - cx) ** 2 < r ** 2
        else:
            sel = (np.abs(yy * size - cy) < r) & (np.abs(xx * size - cx) < r)
        img[sel] = color
        img = np.clip(img + g.normal(0, 0.01, img.shape), 0, 1)

        mask = np.ones((size, size, 1), np.float32)
        mask[cy - q // 2: cy + q // 2, cx - q // 2: cx + q // 2] = 0.0

        crop = (img[cy - q // 2: cy + q // 2, cx - q // 2: cx + q // 2] * 255).astype(np.uint8)
        images.append(img.astype(np.float32) * 2.0 - 1.0)
        masks.append(mask)
        refs.append(clip_preprocess(Image.fromarray(crop)))
    return np.stack(images), np.stack(masks), np.stack(refs).astype(np.float32)


def build_eval_sample(model, sched):
    """(image, mask, ref, x_T, scale) NHWC tensors on the model's device ->
    (z0, z_hat, roundtrip01, pred01): the scene's VAE latent (the posterior
    mode), the DDIM-sampled latent under CFG at ``scale`` (both halves run
    at every scale, as the JAX demo's program does), and both decoded to
    [0,1] images."""
    from pbe_tpu_torch.ops.image import resize_mask
    from pbe_tpu_torch.samplers.cfg import make_cfg_eps_fn
    from pbe_tpu_torch.samplers.ddim import ddim_sample

    to01 = lambda x: ((x.float() + 1.0) / 2.0).clamp(0, 1)

    @torch.inference_mode()
    def eval_sample(image, mask, ref, x_T, scale: float):
        z0 = model.encode_first_stage(image)
        rt = model.decode_first_stage(z0)
        z_inp = model.encode_first_stage(image * mask)
        m_lat = resize_mask(mask, z_inp.shape[1:3]).to(z_inp.dtype)
        c = model.get_conditioning(ref)
        eps_fn = make_cfg_eps_fn(model.apply_model, c, model.uncond_vector(image.shape[0]),
                                 scale, cfg=True)
        z_hat = ddim_sample(eps_fn, sched, x_T, z_inp, m_lat)
        return z0, z_hat, to01(rt), to01(model.decode_first_stage(z_hat))

    return eval_sample


class FixedPairsLoader:
    """Yields the same fixed batch every step (one epoch = ``steps``
    batches). Pass a batch already on the device (``Trainer._put_batch``),
    so the host-to-device copy happens once, not every step."""

    def __init__(self, batch: dict, steps_per_epoch: int):
        self.batch = batch
        self.steps = steps_per_epoch

    def __iter__(self):
        for _ in range(self.steps):
            yield dict(self.batch)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--outdir", default="overfit_demo")
    p.add_argument("--sample_steps", type=int, default=50)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--sample_posterior", action="store_true",
                   help="per-step VAE posterior sampling (reference parity; "
                        "latent_diffusion.py:255-262). Off by default: a random-init "
                        "posterior's std is ~1.8x its mean's RMS, so the sampled target "
                        "is noise-dominated and memorization floors at a latent rel-MSE "
                        "of ~2 however well training works.")
    p.add_argument("--config", default="configs/v1.yaml")
    p.add_argument("--size", type=int, default=512, help="scene side (the JAX demo's 512)")
    p.add_argument("--precision", choices=["full", "autocast"], default="autocast")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def train(model, images, masks, refs, opt):
    """Train on the first ``opt.batch`` pairs for ``opt.steps`` steps at a
    constant LR -> the Trainer."""
    from pbe_tpu_torch.training.trainer import Trainer

    trainer = Trainer(model, base_lr=opt.lr, logdir=opt.outdir, seed=0,
                      scheduler=lambda step: 1.0, det_first_stage=not opt.sample_posterior)
    b = opt.batch
    dbatch = trainer._put_batch({"image": images[:b], "inpaint_image": images[:b] * masks[:b],
                                 "mask": masks[:b], "ref": refs[:b]})
    try:
        trainer.fit(FixedPairsLoader(dbatch, steps_per_epoch=opt.steps), val_loader=None,
                    max_steps=opt.steps, max_epochs=1, log_every=opt.log_every,
                    val_every=10 ** 9, ckpt_every=10 ** 9)
    finally:
        trainer.logger.close()
    return trainer


def summarize(model, images, masks, refs, x_T, opt) -> dict:
    """DDIM at CFG scales 1 and 5 with the trained weights: the latent
    rel-MSE against the VAE's z0 (the decisive metric with a random-init
    VAE, whose decoder turns small latent errors into loud pixel noise) and
    the PSNR of each decode against the VAE round trip; writes the PNGs and
    arrays -> the summary written to overfit_summary.json."""
    from PIL import Image

    from pbe_tpu_torch.schedules import SamplerSchedule

    eval_sample = build_eval_sample(model, SamplerSchedule.create(model.schedule,
                                                                  opt.sample_steps))
    put = lambda a: torch.as_tensor(a, device=model.device).to(model.dtype)
    grids = os.path.join(opt.outdir, "grids")
    os.makedirs(grids, exist_ok=True)

    def latent_viz(z):
        z3 = z[..., :3]
        lo, hi = z3.min(), z3.max()
        return ((z3 - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)

    summary = {}
    for scale in (1.0, 5.0):
        out = eval_sample(put(images), put(masks), put(refs), x_T, scale)
        z0, z_hat, rt, pred = (t.float().cpu().numpy() for t in out)
        rel_mse = float(np.mean((z_hat - z0) ** 2) / np.mean(z0 ** 2))
        psnr = []
        for i in range(len(images)):
            mse = float(np.mean((rt[i] - pred[i]) ** 2))
            psnr.append(10.0 * np.log10(1.0 / max(mse, 1e-12)))
            side = (np.concatenate([rt[i], pred[i]], 1) * 255).astype(np.uint8)
            Image.fromarray(side).save(os.path.join(
                grids, f"roundtrip_vs_pred_scale{scale:g}_pair{i}.png"))
            lat = np.concatenate([latent_viz(z0[i]), latent_viz(z_hat[i])], 1)
            Image.fromarray(lat).resize((512, 256), Image.NEAREST).save(
                os.path.join(grids, f"latent_z0_vs_zhat_scale{scale:g}_pair{i}.png"))
        summary[f"scale{scale:g}"] = {"latent_rel_mse": rel_mse, "psnr_pred_vs_roundtrip": psnr,
                                      "psnr_mean": float(np.mean(psnr))}
        print(f"scale {scale:g}: latent rel-MSE {rel_mse:.4f}, roundtrip PSNR mean "
              f"{np.mean(psnr):.2f} dB")
        np.save(os.path.join(opt.outdir, f"pred_scale{scale:g}.npy"), pred)
        if scale == 5.0:
            np.save(os.path.join(opt.outdir, "roundtrip.npy"), rt)
    with open(os.path.join(opt.outdir, "overfit_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


def loss_curve(outdir: str) -> list:
    """[(step, loss_simple)] from the trainer's metrics.jsonl, written to
    loss_curve.json (and loss_curve.png where matplotlib imports)."""
    losses = []
    with open(os.path.join(outdir, "metrics.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if "train/loss_simple" in row:
                losses.append((row["step"], row["train/loss_simple"]))
    with open(os.path.join(outdir, "loss_curve.json"), "w") as f:
        json.dump(losses, f)
    if losses:
        print(f"loss_simple: {losses[0][1]:.4f} (step {losses[0][0]}) -> "
              f"{losses[-1][1]:.4f} (step {losses[-1][0]})")
        plot_loss_curve(losses, os.path.join(outdir, "loss_curve.png"))
    return losses


def plot_loss_curve(losses, path: str) -> None:
    """Single-series log-y loss curve PNG next to the grids; skipped (and
    said so) where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib not installed: {path} skipped (loss_curve.json has the curve)")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    steps, vals = zip(*losses)
    fig, ax = plt.subplots(figsize=(7, 4), dpi=120)
    ax.plot(steps, vals, color="#2a78d6", linewidth=2)
    ax.set_yscale("log")
    ax.set_xlabel("step")
    ax.set_ylabel("eps-MSE (loss_simple)")
    ax.set_title("Overfit demo: 8 fixed pairs")
    ax.grid(True, which="both", color="#e6e6e6", linewidth=0.6)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    ax.annotate(f"{vals[-1]:.3g}", (steps[-1], vals[-1]), textcoords="offset points",
                xytext=(4, 4), color="#444444")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    print(f"wrote {path}")


def main(argv=None) -> dict:
    """Run the demo; returns {"train_s", "images_per_s", "summary",
    "losses"}."""
    opt = get_parser().parse_args(argv)
    device, dtype = device_and_dtype(opt.device, opt.precision)

    from pbe_tpu_torch.models.pbe import build_from_yaml
    from pbe_tpu_torch.pipelines.loading import init_parameters

    model, _ = build_from_yaml(opt.config, dtype=dtype, attn_impl="flash", device=device,
                               remat=True)
    init_parameters(model, seed=0)
    f = model.latent_downsample
    images, masks, refs = make_pairs(8, opt.size)
    os.makedirs(opt.outdir, exist_ok=True)

    t0 = time.time()
    trainer = train(model, images, masks, refs, opt)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    wall = time.time() - t0
    print(f"trained {opt.steps} steps in {wall:.0f}s ({opt.steps * opt.batch / wall:.1f} "
          f"images/s)")

    # sample with the overfit weights: the masked region should reproduce
    # the memorized shape
    batch = {"image": images, "inpaint_image": images * masks, "mask": masks, "ref": refs,
             "id": [f"pair{i}" for i in range(len(images))]}
    trainer.log_images(batch, outdir=os.path.join(opt.outdir, "grids"),
                       steps=opt.sample_steps, scale=5.0, sampler="ddim")
    print(f"wrote grids to {opt.outdir}/grids")

    gen = torch.Generator(device=model.device).manual_seed(0)
    x_T = torch.randn((len(images), opt.size // f, opt.size // f, 4), generator=gen,
                      device=model.device).to(dtype)
    summary = summarize(model, images, masks, refs, x_T, opt)
    return {"train_s": wall, "images_per_s": opt.steps * opt.batch / wall,
            "summary": summary, "losses": loss_curve(opt.outdir)}


if __name__ == "__main__":
    main()
