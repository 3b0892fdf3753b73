"""Training CLI (port of ``scripts/train.py``), the reference main.py's
surface with OmegaConf-style dotlist overrides:

    python -m pbe_tpu_torch.scripts.train --base configs/v1.yaml --train \\
        [--seed N] [--scale_lr] [--bf16_moments] [--resume] [--logdir DIR] \\
        [--max_steps N] [model.params.timesteps=500 ...]

The flags are the JAX CLI's, plus --device (default cuda; cpu runs the
kernels' plain versions). Without a card and without --device cpu it exits
non-zero. --precision full computes in fp32, on the card through the fp32
attention kernels, with TF32 off. The model is built from the YAML
with remat on, initialized from --seed (or overlaid with --ckpt), and
trained on one device by ``training.Trainer`` over the YAML's data module.
--resume restores the latest checkpoint in --logdir. --sample_images and
--fid_every add validation-time grids and the FID trio (random Inception
weights unless --inception_ckpt). Not ported, and refused with a non-zero
exit: the multi-process path (PBE_COORDINATOR / JAX_COORDINATOR_ADDRESS /
PBE_MULTIHOST in the environment). The JAX CLI's compilation cache has no
counterpart.
"""
from __future__ import annotations

import argparse
import os

import torch

from pbe_tpu_torch.scripts.inference import device_and_dtype, refuse


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--base", nargs="*", default=["configs/v1.yaml"],
                   help="base config yaml(s), merged left-to-right")
    p.add_argument("--train", action="store_true", default=True)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--scale_lr", action="store_true",
                   help="scale base LR by n_devices * batch_size (main.py:366-368)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --logdir")
    p.add_argument("--logdir", type=str, default="logs/pbe")
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--max_epochs", type=int, default=40)
    p.add_argument("--ckpt", type=str, default="",
                   help="reference-format .ckpt to initialize from (SD-v1-4 9ch "
                        "surgery output or a trained PBE checkpoint)")
    p.add_argument("--train_from_scratch", action="store_true",
                   help="drop the diffusion-model ('model.*') keys from --ckpt so the "
                        "UNet trains from random init; only the frozen VAE/CLIP load "
                        "(main.py:244-248)")
    p.add_argument("--sample_images", action="store_true",
                   help="sample 6-panel image grids at every validation "
                        "(latent_diffusion.py:1020-1123 via main.py:287-295)")
    p.add_argument("--fid_every", type=int, default=0,
                   help="stream val/fid_{global,local,ref} every N steps (rides the "
                        "validation cadence; 0 = off; callback_fid.py:146-189)")
    p.add_argument("--fid_batches", type=int, default=2)
    p.add_argument("--sample_steps", type=int, default=50,
                   help="sampler steps for validation-time image grids")
    p.add_argument("--inception_ckpt", type=str, default="",
                   help="torchvision InceptionV3 weights for the FID feature fn (random "
                        "features if empty — fine for trend-tracking, not comparable "
                        "to paper FID)")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--bf16_moments", action="store_true",
                   help="keep Adam first moments in bf16 (halves their memory)")
    p.add_argument("--precision", choices=["full", "autocast"], default="autocast",
                   help="fp32 or bf16 compute (the parameters stay fp32)")
    p.add_argument("--val_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    """Run the CLI; returns the Trainer after ``fit``."""
    if any(os.environ.get(k, "") not in ("", "0")
           for k in ("PBE_COORDINATOR", "JAX_COORDINATOR_ADDRESS", "PBE_MULTIHOST")):
        refuse("PBE_COORDINATOR/PBE_MULTIHOST", "multi-process training", "11")
    opt, unknown = get_parser().parse_known_args(argv)
    device, dtype = device_and_dtype(opt.device, opt.precision)

    from pbe_tpu_torch import config as config_lib
    from pbe_tpu_torch.pipelines.loading import init_parameters, load_checkpoint
    from pbe_tpu_torch.training.trainer import Trainer

    raw: dict = {}
    for path in opt.base:
        raw = {**raw, **config_lib.load_config(path)}
    overrides = [u for u in unknown if "=" in u and not u.startswith("-")]
    config_lib.merge_dotlist(raw, overrides)

    model_cfg = config_lib.instantiate_from_config(raw["model"])
    # the attention kernels on the card (with their backward), their plain
    # versions on the CPU; remat as the JAX CLI builds it
    model = model_cfg.build(dtype=dtype, attn_impl="flash", device=device, remat=True)
    init_parameters(model, seed=opt.seed)
    if opt.ckpt:
        load_checkpoint(model, opt.ckpt,
                        drop_prefixes=("model.",) if opt.train_from_scratch else ())
        if opt.train_from_scratch:
            print("Train from scratch!")  # main.py:248's banner

    data = config_lib.instantiate_from_config(raw["data"])
    train_loader = data.train_dataloader()
    val_loader = data.val_dataloader()

    # base_learning_rate sits beside (not inside) model.params in v1.yaml
    base_lr = raw["model"].get("base_learning_rate", model_cfg.base_learning_rate)
    if opt.scale_lr:
        base_lr = base_lr * 1 * data.batch_size  # one device
        print(f"scaled LR: {base_lr:.2e}")

    # the LR-multiplier schedule from the YAML (v1: LambdaLinearScheduler
    # with a 10k-step warm-up, configs/v1.yaml:21-28)
    scheduler = None
    if model_cfg.scheduler_config:
        scheduler = config_lib.instantiate_from_config(model_cfg.scheduler_config)

    trainer = Trainer(model, base_lr=base_lr, logdir=opt.logdir, use_ema=opt.use_ema,
                      seed=opt.seed, scheduler=scheduler,
                      mu_dtype=torch.bfloat16 if opt.bf16_moments else None)
    if opt.resume and trainer.restore():
        print(f"resumed from step {trainer.step}")

    fid_feature_fn = None
    if opt.fid_every:
        from pbe_tpu_torch.evaltools.fid import make_inception_feature_fn

        fid_feature_fn = make_inception_feature_fn(opt.inception_ckpt or None, device=device)

    try:
        trainer.fit(train_loader, val_loader, max_steps=opt.max_steps,
                    max_epochs=opt.max_epochs, log_every=opt.log_every,
                    val_every=opt.val_every, sample_images=opt.sample_images,
                    fid_feature_fn=fid_feature_fn, fid_batches=opt.fid_batches,
                    fid_every=opt.fid_every or None, sample_steps=opt.sample_steps)
    finally:
        trainer.logger.close()
    return trainer


if __name__ == "__main__":
    main()
