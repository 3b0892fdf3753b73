"""Test-split evaluation (port of ``scripts/test.py``; reference:
test.py:183-397): load a checkpoint, run the test loader through the loss
(with the ``_ema`` metrics where the checkpoint holds EMA weights) and
through full sampling, with the in-loop FID trio (callback_fid.py:146-189).

    python -m pbe_tpu_torch.scripts.test --base configs/v1.yaml --ckpt model.ckpt \\
        [--logdir logs/test] [--limit N] [--ddim_steps 50] [--scale 5] [--plms] \\
        [--precision full|autocast] [--inception_weights w.pt] [--skip_fid] \\
        [data.params.test.params.dataset_dir=DIR ...]

The flags are the JAX CLI's, plus --device (default cuda; without a card and
without --device cpu it exits non-zero). Each batch's loss comes from
``Trainer.validate`` (the step's draws from a generator seeded --seed plus
the batch index, the VAE posterior sampled as the JAX CLI's eval step does);
its samples from ``Trainer.log_images`` (``infer_batch`` and the 6-panel
``visualize_batch`` grids under LOGDIR/images); the FID trio from
``FIDTrioTracker``. Without --inception_weights Inception is randomly
initialized and no FID is a quality number. Writes LOGDIR/test_results.json:
``test/loss_simple``, ``test/loss_vlb``, ``test/loss`` (and ``..._ema``),
``test/fid_{global,local,ref}``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from pbe_tpu_torch.scripts.inference import device_and_dtype


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--base", nargs="*", default=["configs/v1.yaml"])
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--logdir", type=str, default="logs/test")
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--limit", type=int, default=0, help="cap test batches")
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("--plms", action="store_true")
    p.add_argument("--precision", choices=["full", "autocast"], default="autocast")
    p.add_argument("--inception_weights", type=str, default="")
    p.add_argument("--skip_fid", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def ema_from_checkpoint(path: str, params: dict[str, torch.Tensor]) -> dict | None:
    """The reference checkpoint's EMA (LitEma's ``model_ema.*`` buffers: the
    diffusion model's parameter names without their dots) as an
    ``training.ema.EMA`` state over ``params``; trainable parameters it
    does not shadow keep their values. None where it holds no EMA."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob)
    ema = {k.removeprefix("model_ema."): v for k, v in sd.items() if k.startswith("model_ema.")}
    if not ema:
        return None
    shadow = {}
    for k, p in params.items():
        s = k.removeprefix("model.").replace(".", "")
        shadow[k] = (ema[s] if k.startswith("model.") and s in ema else p.detach()).to(p)
    return {"count": int(ema.get("num_updates", torch.tensor(0))), "shadow": shadow}


def main(argv=None) -> dict:
    """Run the CLI; returns the results it writes."""
    opt, unknown = get_parser().parse_known_args(argv)
    device, dtype = device_and_dtype(opt.device, opt.precision)

    from pbe_tpu_torch import config as config_lib
    from pbe_tpu_torch.data.transforms import unpack_uint8_batch
    from pbe_tpu_torch.evaltools.fid import make_inception_feature_fn
    from pbe_tpu_torch.evaltools.fid_callback import FIDTrioTracker
    from pbe_tpu_torch.pipelines.loading import init_parameters, load_checkpoint
    from pbe_tpu_torch.training.trainer import Trainer

    raw: dict = {}
    for path in opt.base:
        raw = {**raw, **config_lib.load_config(path)}
    config_lib.merge_dotlist(raw, [u for u in unknown if "=" in u and not u.startswith("-")])

    model_cfg = config_lib.instantiate_from_config(raw["model"])
    model = model_cfg.build(dtype=dtype, attn_impl="flash", device=device, remat=False)
    init_parameters(model, seed=opt.seed)
    if opt.ckpt:
        load_checkpoint(model, opt.ckpt)

    data = config_lib.instantiate_from_config(raw["data"])
    loader = data.test_dataloader() or data.val_dataloader()
    if loader is None:
        raise SystemExit("config has no test/validation data section")

    os.makedirs(opt.logdir, exist_ok=True)
    trainer = Trainer(model, logdir=opt.logdir, seed=opt.seed)
    ema = ema_from_checkpoint(opt.ckpt, trainer.params) if opt.ckpt else None
    if ema is not None:
        from pbe_tpu_torch.training.ema import EMA

        trainer.ema = EMA(trainer.params)
        trainer.ema.load_state_dict(ema)
        print(f"EMA weights found ({ema['count']} updates): the _ema metrics too")
    tracker = None
    if not opt.skip_fid:
        if not opt.inception_weights:
            print("WARNING: no --inception_weights; Inception is randomly initialized "
                  "(FID values are not meaningful)", file=sys.stderr)
        tracker = FIDTrioTracker(
            make_inception_feature_fn(opt.inception_weights or None, device=device),
            device=device)

    agg: dict[str, list[float]] = {}
    try:
        for i, batch in enumerate(loader):
            if opt.limit and i >= opt.limit:
                break
            metrics = trainer.validate([batch], max_batches=1, seed=opt.seed + i)
            for k, v in metrics.items():
                agg.setdefault(f"test/{k}", []).append(v)
            preds = trainer.log_images(batch, outdir=os.path.join(opt.logdir, "images"),
                                       steps=opt.ddim_steps, scale=opt.scale,
                                       sampler="plms" if opt.plms else "ddim", seed=opt.seed)
            if tracker is not None:
                tracker.update(unpack_uint8_batch(batch), preds)
            print(f"batch {i}: " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()),
                  flush=True)
    finally:
        trainer.logger.close()

    results = {k: float(np.mean(v)) for k, v in agg.items()}
    if tracker is not None and tracker.stats["global"][0].n > 1:
        results.update({f"test/{k}": v for k, v in tracker.compute().items()})
    with open(os.path.join(opt.logdir, "test_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
