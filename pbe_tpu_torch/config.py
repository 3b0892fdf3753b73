"""Config system: YAML files with ``target:`` / ``params:`` dependency injection.

The port's copy of ``pbe_tpu/config.py``: the same configs/v1.yaml and
configs/tiny.yaml load here, with the reference's dotted ``target`` strings
remapped onto this package's config classes: every alias the JAX package
registers (the model, its legacy classifier, text and conditioning
encoders, the LR schedules, the OpenImages, quadruple, COCOEE test-bench
and legacy ImageNet/LSUN datasets and the data module), with
``torch.nn.Identity`` left to torch's own class. Anything else resolves by
plain dotted import, and the reference's ``"__is_first_stage__"`` /
``"__is_unconditional__"`` sentinels are returned as they are. The VAE's
``lossconfig`` is kept as a dict and never built. CLI overrides
(``model.params.timesteps=500``) merge with :func:`merge_dotlist`, as
OmegaConf's ``from_dotlist`` did for the reference's main.py.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable

import yaml

_P = "pbe_tpu_torch."
_TARGET_ALIASES: dict[str, str] = {
    "ldm.models.diffusion.ddpm.LatentDiffusion": _P + "models.pbe.PaintByExampleConfig",
    "ldm.models.diffusion.latent_diffusion.LatentDiffusion": _P + "models.pbe.PaintByExampleConfig",
    "ldm.modules.diffusionmodules.openaimodel.UNetModel": _P + "models.unet.UNetConfig",
    "ldm.modules.diffusionmodules.openaimodel.EncoderUNetModel":
        _P + "models.encoder_unet.EncoderUNetConfig",
    "ldm.models.autoencoder.AutoencoderKL": _P + "models.vae.AutoencoderKLConfig",
    "ldm.modules.encoders.modules.FrozenCLIPImageEmbedder": _P + "models.exemplar.ExemplarEncoderConfig",
    "ldm.modules.encoders.modules.BERTEmbedder": _P + "models.text_transformer.BERTEmbedderConfig",
    "ldm.modules.encoders.modules.TransformerEmbedder":
        _P + "models.text_transformer.TransformerEmbedderConfig",
    "ldm.modules.encoders.modules.ClassEmbedder": _P + "models.text_transformer.ClassEmbedder",
    "ldm.modules.encoders.modules.SpatialRescaler": _P + "models.text_transformer.SpatialRescaler",
    "torch.nn.Identity": "torch.nn.Identity",
    "ldm.lr_scheduler.LambdaLinearScheduler": _P + "training.lr_schedule.LambdaLinearScheduler",
    "ldm.lr_scheduler.LambdaWarmUpCosineScheduler": _P + "training.lr_schedule.LambdaWarmUpCosineScheduler",
    "ldm.lr_scheduler.LambdaWarmUpCosineScheduler2": _P + "training.lr_schedule.LambdaWarmUpCosineScheduler2",
    "ldm.data.open-images.OpenImageDataset": _P + "data.openimages.OpenImagesDataset",
    "ldm.data.open-images.PBEQuadrupleDataset": _P + "data.quadruple.QuadrupleDataset",
    "ldm.data.test_bench_dataset.COCOImageDataset": _P + "data.test_bench.COCOEEDataset",
    "main.DataModuleFromConfig": _P + "data.loader.DataModuleConfig",
    **{f"ldm.data.imagenet.{name}": _P + f"data.legacy.{name}"
       for name in ("ImageNetTrain", "ImageNetValidation", "ImageNetSRTrain",
                    "ImageNetSRValidation")},
    **{f"ldm.data.lsun.LSUN{name}{split}": _P + f"data.legacy.LSUN{name}{split}"
       for name in ("Churches", "Bedrooms", "Cats") for split in ("Train", "Validation")},
}

# the reference's placeholders for a stage its LatentDiffusion builds itself
SENTINELS = ("__is_first_stage__", "__is_unconditional__")


def get_obj_from_str(string: str) -> Callable[..., Any]:
    string = _TARGET_ALIASES.get(string, string)
    module, cls = string.rsplit(".", 1)
    return getattr(importlib.import_module(module), cls)


def instantiate_from_config(config: dict[str, Any]) -> Any:
    if not isinstance(config, dict) or "target" not in config:
        if config in SENTINELS:
            return config
        raise KeyError(f"Expected a dict with a `target` key, got: {config!r}")
    return get_obj_from_str(config["target"])(**config.get("params", {}))


def load_config(path: str) -> dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def merge_dotlist(config: dict[str, Any], dotlist: list[str]) -> dict[str, Any]:
    """Apply ``a.b.c=value`` overrides in place (values parsed as YAML
    scalars), returning the config."""
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not of the form key=value")
        key, value = item.split("=", 1)
        node = config
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(value)
    return config
