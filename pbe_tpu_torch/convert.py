"""Flax parameter tree -> the port's torch state_dict.

The port's modules carry the reference state_dict names (the keys
``pbe_tpu/convert/to_torch.py`` emits) with torch layouts, so weights move
between the two packages by a key rewrite plus two layout transforms:

  * conv kernel (kH, kW, I, O)  ->  weight (O, I, kH, kW)
  * dense kernel (I, O)         ->  weight (O, I)
  * <module>/norm/{scale, bias} ->  <module>.{weight, bias}

Two keys differ from that exporter, and follow the reference instead:
the class embedding is ``label_emb.weight`` (an ``nn.Embedding``) and the
fork's front block is ``add_resbolck.N.M`` (dotted like the other blocks).
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch


def flatten_params(tree: Mapping[str, Any], prefix: tuple = ()) -> dict[tuple, Any]:
    """Nested dict -> {path tuple: leaf}."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(flatten_params(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def torch_key_and_value(path: tuple[str, ...], arr: np.ndarray):
    """flax param path -> (torch key, array in torch layout)."""
    if path == ("learnable_vector",):
        return "learnable_vector", arr
    if path[:2] == ("cond_stage_model", "transformer") and path[-1] in (
        "class_embedding", "position_embedding",
    ):
        suffix = ".weight" if path[-1] == "position_embedding" else ""
        return (
            "cond_stage_model.transformer.vision_model.embeddings."
            + path[-1] + suffix, arr,
        )

    parts = list(path)
    leaf = parts.pop()
    if parts and parts[-1] == "norm":
        parts.pop()
        leaf = {"scale": "weight", "bias": "bias"}[leaf]
    elif leaf == "kernel":
        leaf = "weight"
        arr = (np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4
               else np.transpose(arr, (1, 0)))
    elif leaf == "embedding":  # nn.Embed -> nn.Embedding
        leaf = "weight"

    out: list[str] = []
    for i, p in enumerate(parts):
        if i == 0 and p == "model":
            out += ["model", "diffusion_model"]
            continue
        if i == 0:
            out.append(p)
            continue
        p = p.replace("net_0_proj", "net.0.proj").replace("net_2", "net.2")
        p = p.replace("to_out_0", "to_out.0")
        p = re.sub(r"^(input_blocks|output_blocks|add_resbolck)_(\d+)_(\d+)$",
                   r"\1.\2.\3", p)
        p = re.sub(r"^middle_block_(\d+)$", r"middle_block.\1", p)
        p = re.sub(r"^time_embed_(\d+)$", r"time_embed.\1", p)
        p = re.sub(r"^out_(\d+)$", r"out.\1", p)
        p = re.sub(r"^(in_layers|out_layers|emb_layers)_(\d+)$", r"\1.\2", p)
        p = re.sub(r"^transformer_blocks_(\d+)$", r"transformer_blocks.\1", p)
        p = re.sub(r"^(down|up)_(\d+)_block_(\d+)$", r"\1.\2.block.\3", p)
        p = re.sub(r"^(down|up)_(\d+)_attn_(\d+)$", r"\1.\2.attn.\3", p)
        p = re.sub(r"^(down|up)_(\d+)_(downsample|upsample)$", r"\1.\2.\3", p)
        p = re.sub(r"^mid_(block_[12]|attn_1)$", r"mid.\1", p)
        p = re.sub(r"^mapper_resblocks_(\d+)$", r"mapper.resblocks.\1", p)
        p = re.sub(r"^(attn|mlp)_(c_\w+)$", r"\1.\2", p)
        p = re.sub(r"^mlp_(fc[12])$", r"mlp.\1", p)
        p = re.sub(r"^layers_(\d+)$", r"encoder.layers.\1", p)
        out.append(p)
    if path[:2] == ("cond_stage_model", "transformer"):
        tail = out[2:]
        if tail and tail[0] == "patch_embedding":
            tail = ["embeddings"] + tail
        out = out[:2] + ["vision_model"] + tail
    return ".".join(out + [leaf]), arr


def state_dict_from_flax(params_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """params_np: the nested tree under 'params' (numpy or array-likes).
    Returns {torch key: float32 CPU tensor} for ``load_state_dict``."""
    sd = {}
    for path, arr in flatten_params(params_np).items():
        key, value = torch_key_and_value(path, np.asarray(arr, np.float32))
        sd[key] = torch.from_numpy(np.array(value, np.float32))
    return sd


def _layer_param(path: tuple[str, ...], arr: np.ndarray) -> tuple[list[str], str, np.ndarray]:
    """A flax conv/dense/norm leaf -> (torch module path, torch leaf, value in
    torch layout); a GroupNorm32's inner ``norm`` scope is dropped."""
    *mods, leaf = path
    if mods and mods[-1] == "norm" and leaf in ("scale", "bias"):
        mods.pop()
    if leaf == "kernel":
        return mods, "weight", (np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4
                                else np.transpose(arr, (1, 0)))
    return mods, {"scale": "weight"}.get(leaf, leaf), arr


def _tensors(items) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in items}


def discriminator_state_dict_from_flax(params_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``training.vae_train.PatchDiscriminator`` params (the tree under
    'params') -> the port's state_dict: the module names are flax's."""
    items = []
    for path, arr in flatten_params(params_np).items():
        mods, leaf, value = _layer_param(path, np.asarray(arr, np.float32))
        items.append((".".join(mods + [leaf]), value))
    return _tensors(items)


def vgg16_state_dict_from_flax(params_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``training.perceptual.VGG16Features`` params -> the port's
    state_dict (torchvision's ``features.<i>`` keys for flax's ``conv_<i>``)."""
    items = []
    for path, arr in flatten_params(params_np).items():
        mods, leaf, value = _layer_param(path, np.asarray(arr, np.float32))
        items.append((f"features.{mods[0].removeprefix('conv_')}.{leaf}", value))
    return _tensors(items)


def asym_decoder_state_dict_from_flax(params_np: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``models.vae_asym.AsymmetricDecoder`` params -> the port's state_dict:
    the trunk by the first stage's decoder key map, the conditional branch's
    ``level_<i>_block``/``level_<i>_down`` as ``level_block.<i>``/
    ``level_down.<i>``, ``cond_proj_<i>`` as ``cond_proj.<i>``, and the
    scalars ``blend_scale_<i>`` as one vector ``blend_scale``."""
    items, scales = [], {}
    for path, arr in flatten_params(params_np).items():
        arr = np.asarray(arr, np.float32)
        if path[0].startswith("blend_scale_"):
            scales[int(path[0].removeprefix("blend_scale_"))] = float(arr)
        elif path[0] == "cond_encoder" or path[0].startswith("cond_proj_"):
            mods, leaf, value = _layer_param(path, arr)
            mods = [re.sub(r"^level_(\d+)_(block|down)$", r"level_\2.\1", m) for m in mods]
            mods = [re.sub(r"^cond_proj_(\d+)$", r"cond_proj.\1", m) for m in mods]
            items.append((".".join(mods + [leaf]), value))
        else:
            key, value = torch_key_and_value(("decoder",) + path, arr)
            items.append((key.removeprefix("decoder."), value))
    items.append(("blend_scale", np.asarray([scales[i] for i in range(len(scales))])))
    return _tensors(items)
