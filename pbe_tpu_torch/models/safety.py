"""Stable-Diffusion safety checker (port of ``pbe_tpu/models/safety.py``).

diffusers' ``StableDiffusionSafetyChecker`` as the reference loads and
calls it: a CLIP vision tower whose projected pooled embedding is
cosine-compared with 17 "concept" and 3 "special care" embeddings. An image
is flagged when any concept score ``round(cos - threshold + adjustment, 3)``
is positive, where the 0.01 adjustment applies once any special-care score
is positive; flagged images are replaced by black frames.

The reference discards the verdict one line after computing it, so the edit
CLI's default is report-only and ``--enforce_safety`` applies the blackout.
The checker runs only on weights the user supplies (nothing is downloaded),
in fp32 by default, as the JAX package's does. Module keys follow diffusers'
state_dict (``vision_model.vision_model.*``, ``visual_projection.weight`` and
the four concept banks at the root), so a diffusers checkpoint loads with
``strict=True`` once the keys no module holds (``position_ids``) are dropped,
as the JAX converter drops them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from pbe_tpu_torch.models.clip_vit import CLIPVisionConfig
from pbe_tpu_torch.models.layers import Linear
from pbe_tpu_torch.ops.image import CLIP_MEAN, CLIP_STD, resize_weights


def cosine_distance(image_embeds: torch.Tensor, concept_embeds: torch.Tensor) -> torch.Tensor:
    """Row-normalized ``image_embeds @ concept_embeds.T`` (diffusers'
    ``cosine_distance``; despite the name it is a cosine similarity)."""
    a = image_embeds / torch.linalg.norm(image_embeds, dim=-1, keepdim=True)
    b = concept_embeds / torch.linalg.norm(concept_embeds, dim=-1, keepdim=True)
    return a @ b.T


def _round3(x: torch.Tensor) -> torch.Tensor:
    # diffusers rounds scores to 3 decimals before comparing them with 0;
    # torch.round rounds half to even, as jnp.round does. A tensor divisor:
    # on CUDA a Python scalar divides as a product with its reciprocal
    return torch.round(x * 1000.0) / torch.tensor(1000.0, device=x.device)


def safety_scores(image_embeds: torch.Tensor, concept_embeds: torch.Tensor,
                  concept_thresholds: torch.Tensor, special_embeds: torch.Tensor,
                  special_thresholds: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(has_nsfw[b], concept_scores[b,17], special_scores[b,3]).

    The diffusers per-image loop, vectorized: its running adjustment starts
    at 0 and becomes 0.01 only after a special score is positive, so the
    first positive special score is always taken at adjustment 0 and "any
    special care" is exactly ``any(round3(cos - thr) > 0)``; all concept
    scores then share the 0.01 adjustment."""
    special_cos = cosine_distance(image_embeds, special_embeds)
    concept_cos = cosine_distance(image_embeds, concept_embeds)
    special_scores = _round3(special_cos - special_thresholds)
    special_care = (special_scores > 0).any(dim=-1)
    adjustment = torch.where(special_care, 0.01, 0.0)
    concept_scores = _round3(concept_cos - concept_thresholds + adjustment[:, None])
    has_nsfw = (concept_scores > 0).any(dim=-1)
    return has_nsfw, concept_scores, special_scores


class SafetyChecker(nn.Module):
    """CLIP vision tower + bias-free visual projection + the fixed concept
    banks, under diffusers' state_dict keys."""

    def __init__(self, hidden_size: int = 1024, num_layers: int = 24, num_heads: int = 16,
                 mlp_dim: int = 4096, patch_size: int = 14, image_size: int = 224,
                 projection_dim: int = 768, num_concepts: int = 17, num_special: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.image_size = image_size
        self.vision_model = CLIPVisionConfig(hidden_size, num_layers, num_heads, mlp_dim,
                                             patch_size, image_size).build(dtype)
        self.visual_projection = Linear(hidden_size, projection_dim, bias=False)
        frozen = lambda *shape: nn.Parameter(torch.ones(shape), requires_grad=False)
        self.concept_embeds = frozen(num_concepts, projection_dim)
        self.special_care_embeds = frozen(num_special, projection_dim)
        self.concept_embeds_weights = frozen(num_concepts)
        self.special_care_embeds_weights = frozen(num_special)

    def embed(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(b, image_size, image_size, 3) CLIP-normalized -> (b, projection_dim)
        fp32 image embeddings."""
        _, pooled = self.vision_model(pixel_values)
        return self.visual_projection(pooled.float())

    def forward(self, pixel_values: torch.Tensor):
        return safety_scores(self.embed(pixel_values), self.concept_embeds,
                             self.concept_embeds_weights, self.special_care_embeds,
                             self.special_care_embeds_weights)


def cubic_resize(images: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(images, (B, h, w, C), "cubic")`` of (B, H, W, C)
    fp32 images; an axis whose size does not change is left as it is, as
    JAX leaves it."""
    x = images.float()
    if h != x.shape[1]:
        x = torch.einsum("bhwc,hi->biwc", x, resize_weights(x.shape[1], h, "cubic", x.device))
    if w != x.shape[2]:
        x = torch.einsum("bhwc,wj->bhjc", x, resize_weights(x.shape[2], w, "cubic", x.device))
    return x


def preprocess_for_safety(images01: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """[0,1] NHWC frames -> CLIP-normalized (b, image_size, image_size, 3):
    the reference's CLIPFeatureExtractor (shortest edge to image_size by
    antialiased bicubic resampling, centre crop, CLIP normalization)."""
    b, h, w, c = images01.shape
    if h <= w:
        nh, nw = image_size, max(image_size, round(w * image_size / h))
    else:
        nh, nw = max(image_size, round(h * image_size / w)), image_size
    x = cubic_resize(images01, nh, nw)
    top, left = (nh - image_size) // 2, (nw - image_size) // 2
    x = x[:, top:top + image_size, left:left + image_size, :].clamp(0.0, 1.0)
    mean, std = (torch.from_numpy(a).to(x.device) for a in (CLIP_MEAN, CLIP_STD))
    return (x - mean) / std


@dataclasses.dataclass
class LoadedSafetyChecker:
    """A checker with its weights: ``check(images01, enforce)``."""

    module: SafetyChecker

    @property
    def device(self) -> torch.device:
        return self.module.visual_projection.weight.device

    @torch.inference_mode()
    def scores(self, images01: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(has_nsfw, concept_scores, special_scores) of (b,h,w,3) [0,1]
        images as numpy. fp32 convolutions and products run without TF32
        (cuDNN's convolutions default to it, and a 3-decimal score can flip
        on it)."""
        x = torch.from_numpy(np.asarray(images01, np.float32)).to(self.device)
        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            out = self.module(preprocess_for_safety(x, self.module.image_size))
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        return tuple(t.cpu().numpy() for t in out)

    def check(self, images01: np.ndarray, enforce: bool = False
              ) -> tuple[np.ndarray, list[bool]]:
        """images01: (b,h,w,3) float [0,1] -> (images, has_nsfw). With
        ``enforce`` the flagged frames are blacked out (what diffusers does);
        without, the images pass through untouched (what the reference does
        in effect)."""
        has_nsfw = [bool(v) for v in self.scores(images01)[0]]
        out = np.array(images01, copy=True)
        if enforce:
            for i, flag in enumerate(has_nsfw):
                if flag:
                    out[i] = 0.0
        return out, has_nsfw


def load_safety_checker(path: str, dtype: torch.dtype = torch.float32,
                        device: str | torch.device = "cuda") -> LoadedSafetyChecker:
    """A SafetyChecker on ``device`` from a diffusers checkpoint (.bin, .pt,
    .ckpt or .safetensors), its geometry inferred from the tensors' shapes as
    the JAX loader infers it (heads of 64 channels, as in every CLIP);
    ``dtype`` is the tower's compute dtype."""
    if path.endswith(".safetensors"):  # safetensors is imported only for such a file
        from safetensors.torch import load_file

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = sd.get("state_dict", sd)
    prefix = "vision_model.vision_model."
    pos = sd[prefix + "embeddings.position_embedding.weight"]
    patch = sd[prefix + "embeddings.patch_embedding.weight"]
    fc1 = sd[prefix + "encoder.layers.0.mlp.fc1.weight"]
    n_layers = 1 + max(int(k.split(".")[4]) for k in sd
                       if k.startswith(prefix + "encoder.layers."))
    hidden, patch_size = int(patch.shape[0]), int(patch.shape[-1])
    grid = int(round((pos.shape[0] - 1) ** 0.5))
    module = SafetyChecker(
        hidden_size=hidden, num_layers=n_layers, num_heads=hidden // 64,
        mlp_dim=int(fc1.shape[0]), patch_size=patch_size, image_size=grid * patch_size,
        projection_dim=int(sd["visual_projection.weight"].shape[0]),
        num_concepts=int(sd["concept_embeds"].shape[0]),
        num_special=int(sd["special_care_embeds"].shape[0]), dtype=dtype)
    keys = module.state_dict().keys()
    # the keys no module holds (a tower's position_ids buffer) are dropped,
    # as the JAX converter drops them; every module key must be there
    module.load_state_dict({k: torch.as_tensor(v).float() for k, v in sd.items() if k in keys},
                           strict=True)
    return LoadedSafetyChecker(module.to(device).eval())
