"""Config system: YAML files with ``target:`` / ``params:`` dependency injection.

The port's copy of ``pbe_tpu/config.py``: the same configs/v1.yaml and
configs/tiny.yaml load here, with the reference's dotted ``target`` strings
remapped onto this package's config classes. Only the targets the edit path
needs are registered; anything else resolves by plain dotted import. The
VAE's ``lossconfig`` is kept as a dict and never built.
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
