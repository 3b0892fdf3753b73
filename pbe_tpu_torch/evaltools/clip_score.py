"""Region CLIP score (port of ``pbe_tpu/evaltools/clip_score.py``).

Spec: eval_tool/clip_score/region_clip_score.py:28-43 — for each (result,
exemplar) pair: crop the result to the mask bbox, resize to 224, embed both
with CLIP ViT-B/32 image encoder, cosine similarity x100, mean over pairs.

The embedder is the port's CLIP tower at the B/32 config plus the CLIP
joint-space visual projection and an L2 norm. Weights come from any HF
``CLIPVisionModelWithProjection`` / ``CLIPModel`` state_dict (the tower's
keys are HF's ``vision_model.*``; bring your own file, nothing is
downloaded). Host-side preprocessing (PIL bicubic from uint8, the CLIP
mean/std in float32 numpy) is the JAX module's, so only the tower differs.
"""
from __future__ import annotations

import numpy as np
import torch
from PIL import Image
from torch import nn

from pbe_tpu_torch.data.masks import mask_bbox
from pbe_tpu_torch.models.clip_vit import CLIPVisionConfig
from pbe_tpu_torch.models.layers import init_like_flax
from pbe_tpu_torch.ops.image import CLIP_MEAN, CLIP_STD

VIT_B32 = CLIPVisionConfig(
    hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072,
    patch_size=32, image_size=224,
)


class CLIPImageEmbedder(nn.Module):
    """Pooled CLIP features + optional joint-space projection + L2 norm.

    ``state_dict`` is the tower's (``vision_model.*`` keys); without one the
    tower is randomly initialized from ``seed`` (mechanics only).
    ``projection`` is (hidden, proj_dim), the transpose of HF's
    ``visual_projection.weight``. The tower computes in bf16 on the card
    and in fp32 on the CPU; the projection and the norm in fp32.
    """

    def __init__(self, config: CLIPVisionConfig = VIT_B32,
                 state_dict: dict | None = None,
                 projection: np.ndarray | torch.Tensor | None = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        self.device = device
        self.tower = config.build(dtype).to(device).eval()  # fp32 weights
        if state_dict is None:
            init_like_flax(self.tower, seed)
        else:
            self.tower.load_state_dict(state_dict)
        # weights stay runtime tensors of the module
        self.register_buffer("projection", None if projection is None else torch.as_tensor(
            np.asarray(projection, np.float32)).to(device))

    @torch.inference_mode()
    def forward(self, images01: np.ndarray) -> np.ndarray:
        """(B,224,224,3) in [0,1] -> (B,D) float32 unit embeddings."""
        x = (np.asarray(images01, np.float32) - CLIP_MEAN) / CLIP_STD
        _, pooled = self.tower(torch.from_numpy(np.ascontiguousarray(x)).to(self.device))
        pooled = pooled.float()
        if self.projection is not None:
            pooled = pooled @ self.projection
        return (pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)).cpu().numpy()

    @classmethod
    def from_torch(cls, path: str, config: CLIPVisionConfig = VIT_B32,
                   device: str | torch.device = "cuda") -> "CLIPImageEmbedder":
        """Load from an HF CLIPModel / CLIPVisionModelWithProjection
        state_dict file (``visual_projection.weight`` picked up if
        present; text-side keys and buffers such as ``position_ids``
        dropped)."""
        sd = torch.load(path, map_location="cpu", weights_only=False)
        sd = sd.get("state_dict", sd)
        proj = sd.get("visual_projection.weight")
        keys = set(config.build().state_dict())
        tower_sd = {k: v for k, v in sd.items() if k in keys}
        return cls(config, state_dict=tower_sd,
                   projection=None if proj is None else proj.float().numpy().T,
                   device=device)


def crop_to_mask_bbox(image01: np.ndarray, mask_edit: np.ndarray,
                      size: int = 224) -> np.ndarray:
    """Crop result to the tight bbox of the edit region, resize to 224
    (region_clip_score.py:31-38 / test_bench_dataset.py:80-86)."""
    bb = mask_bbox(mask_edit)
    if bb is None:
        crop = image01
    else:
        x1, y1, x2, y2 = bb
        crop = image01[y1:y2, x1:x2]
    img = Image.fromarray((np.clip(crop, 0, 1) * 255).astype(np.uint8))
    return np.asarray(img.resize((size, size), Image.BICUBIC), np.float32) / 255.0


def region_clip_score(
    embedder: CLIPImageEmbedder,
    results01: list[np.ndarray],
    refs01: list[np.ndarray],
    masks_edit: list[np.ndarray],
    batch_size: int = 64,
) -> float:
    """Mean cosine x100 over pairs."""
    crops = np.stack([
        crop_to_mask_bbox(r, m) for r, m in zip(results01, masks_edit)
    ])
    refs = np.stack([
        np.asarray(
            Image.fromarray((np.clip(r, 0, 1) * 255).astype(np.uint8)).resize(
                (224, 224), Image.BICUBIC), np.float32) / 255.0
        for r in refs01
    ])
    sims = []
    for i in range(0, len(crops), batch_size):
        a = embedder(crops[i:i + batch_size])
        b = embedder(refs[i:i + batch_size])
        sims.append((a * b).sum(axis=-1))
    return float(np.concatenate(sims).mean() * 100.0)
