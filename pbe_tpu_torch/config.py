"""Config system: YAML files with ``target:`` / ``params:`` dependency injection.

The port's copy of ``pbe_tpu/config.py``: the same configs/v1.yaml and
configs/tiny.yaml load here, with the reference's dotted ``target`` strings
remapped onto this package's config classes. Only the targets the edit and
training paths need are registered (the model, the LR schedules, the
OpenImages and quadruple datasets and the data module); anything else
resolves by plain dotted import. The VAE's ``lossconfig`` is kept as a dict
and never built. CLI overrides (``model.params.timesteps=500``) merge with
:func:`merge_dotlist`, as OmegaConf's ``from_dotlist`` did for the
reference's main.py.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable

import yaml

_TARGET_ALIASES: dict[str, str] = {
    "ldm.models.diffusion.ddpm.LatentDiffusion": "pbe_tpu_torch.models.pbe.PaintByExampleConfig",
    "ldm.models.diffusion.latent_diffusion.LatentDiffusion": "pbe_tpu_torch.models.pbe.PaintByExampleConfig",
    "ldm.modules.diffusionmodules.openaimodel.UNetModel": "pbe_tpu_torch.models.unet.UNetConfig",
    "ldm.models.autoencoder.AutoencoderKL": "pbe_tpu_torch.models.vae.AutoencoderKLConfig",
    "ldm.modules.encoders.modules.FrozenCLIPImageEmbedder": "pbe_tpu_torch.models.exemplar.ExemplarEncoderConfig",
    "ldm.lr_scheduler.LambdaLinearScheduler": "pbe_tpu_torch.training.lr_schedule.LambdaLinearScheduler",
    "ldm.lr_scheduler.LambdaWarmUpCosineScheduler": "pbe_tpu_torch.training.lr_schedule.LambdaWarmUpCosineScheduler",
    "ldm.lr_scheduler.LambdaWarmUpCosineScheduler2": "pbe_tpu_torch.training.lr_schedule.LambdaWarmUpCosineScheduler2",
    "ldm.data.open-images.OpenImageDataset": "pbe_tpu_torch.data.openimages.OpenImagesDataset",
    "ldm.data.open-images.PBEQuadrupleDataset": "pbe_tpu_torch.data.quadruple.QuadrupleDataset",
    "main.DataModuleFromConfig": "pbe_tpu_torch.data.loader.DataModuleConfig",
}


def get_obj_from_str(string: str) -> Callable[..., Any]:
    string = _TARGET_ALIASES.get(string, string)
    module, cls = string.rsplit(".", 1)
    return getattr(importlib.import_module(module), cls)


def instantiate_from_config(config: dict[str, Any]) -> Any:
    if not isinstance(config, dict) or "target" not in config:
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
