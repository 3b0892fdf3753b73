"""In-training FID trio: global / local (mask-bbox crops) / ref-vs-crop
(port of ``pbe_tpu/evaltools/fid_callback.py``).

Spec: the reference's callback_fid.py:79-189 —
  * fid_global: full GT images vs full predictions
  * fid_local: 299² crops of the mask bbox from GT vs prediction
  * fid_ref: exemplar images vs prediction crops
accumulated with streaming statistics across batches.

Resampling is the JAX package's: ``jax.image.scale_and_translate`` /
``jax.image.resize`` with the bilinear (triangle) kernel, which antialiases
when it downscales. PyTorch has no call for a per-box crop with fractional
edges, so :func:`resample_weights` builds the same separable weight
matrices (``jax/_src/image/scale.py`` ``compute_weight_mat``) and each image
is two small products.
"""
from __future__ import annotations

import numpy as np
import torch

from pbe_tpu_torch.data.transforms import unnormalize, unnormalize_clip
from pbe_tpu_torch.evaltools.fid import RunningStats, frechet_distance
from pbe_tpu_torch.models.pbe import resolve_device


def bboxes_from_masks(masks_edit: torch.Tensor) -> torch.Tensor:
    """(B,H,W,1) edit masks -> (B,4) [y1,x1,y2,x2] float32 boxes; the full
    image when the mask is empty (callback_fid.py:23-34)."""
    m = masks_edit[..., 0] > 0.5
    b, h, w = m.shape
    rows, cols = m.any(dim=2), m.any(dim=1)
    ridx = torch.arange(h, device=m.device)[None, :]
    cidx = torch.arange(w, device=m.device)[None, :]
    y1 = torch.where(rows, ridx, h).amin(dim=1)
    y2 = torch.where(rows, ridx + 1, 0).amax(dim=1)
    x1 = torch.where(cols, cidx, w).amin(dim=1)
    x2 = torch.where(cols, cidx + 1, 0).amax(dim=1)
    empty = ~m.any(dim=(1, 2))
    y1 = torch.where(empty, 0, y1)
    x1 = torch.where(empty, 0, x1)
    y2 = torch.where(empty, h, y2)
    x2 = torch.where(empty, w, x2)
    return torch.stack([y1, x1, y2, x2], dim=1).float()


def resample_weights(in_size: int, out_size: int, inv_scale: torch.Tensor,
                     translation: torch.Tensor) -> torch.Tensor:
    """(B,) fp32 inverse scale and translation -> (B, in_size, out_size)
    weights of JAX's antialiased triangle kernel: output pixel j samples
    input coordinate (j + 0.5 - t) / s - 0.5, weights normalized per output
    pixel, zero where the sample lies outside the input."""
    dev = inv_scale.device
    inv = inv_scale[:, None, None]
    kernel_scale = torch.clamp(inv, min=1.0)
    out_idx = torch.arange(out_size, dtype=torch.float32, device=dev)[None, None, :]
    in_idx = torch.arange(in_size, dtype=torch.float32, device=dev)[None, :, None]
    sample = (out_idx + 0.5) * inv - translation[:, None, None] * inv - 0.5
    w = torch.clamp(1.0 - torch.abs(sample - in_idx) / kernel_scale, min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside, w, 0.0)


def _resample(images: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """(B,H,W,C) with (B,H,oh) and (B,W,ow) weights -> (B,oh,ow,C)."""
    t = torch.einsum("bhwc,bwj->bhjc", images, wx)
    return torch.einsum("bhjc,bhi->bijc", t, wy)


def crop_and_resize(images: torch.Tensor, boxes: torch.Tensor, size: int = 299) -> torch.Tensor:
    """Bilinear ROI crop-and-resize, (B,H,W,C) + (B,4 yxyx) -> (B,size,size,C),
    as ``jax.image.scale_and_translate`` with scale size/(y2-y1) and
    translation -y1*scale per axis."""
    images = images.float()
    y1, x1, y2, x2 = boxes.float().unbind(dim=1)
    # quotients of tensors, as JAX rounds them (``size / t`` in torch is a
    # product with the reciprocal)
    n = torch.full_like(y1, size)
    sy, sx = n / (y2 - y1), n / (x2 - x1)
    wy = resample_weights(images.shape[1], size, torch.ones_like(sy) / sy, -y1 * sy)
    wx = resample_weights(images.shape[2], size, torch.ones_like(sx) / sx, -x1 * sx)
    return _resample(images, wy, wx)


def resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(images, (B, size, size, C), "bilinear")``."""
    images = images.float()
    b, h, w, _ = images.shape
    # JAX takes the scale as a Python float and its inverse in double,
    # rounded to fp32 where it meets the fp32 grid
    inv = lambda n: torch.full((b,), 1.0 / (size / n), dtype=torch.float32,
                               device=images.device)
    zero = torch.zeros((b,), dtype=torch.float32, device=images.device)
    return _resample(images, resample_weights(h, size, inv(h), zero),
                     resample_weights(w, size, inv(w), zero))


class FIDTrioTracker:
    """Streaming FID over (real, fake) pairs for the global/local/ref views.
    ``feature_fn`` takes (B,size,size,3) [0,1] tensors on ``device`` (CUDA
    unless the caller asks for another; raises without a card) and returns
    (B,D) features (numpy or a tensor)."""

    def __init__(self, feature_fn, size: int = 299,
                 device: str | torch.device | None = None):
        self.feature_fn = feature_fn
        self.size = size
        self.device = resolve_device(device)
        self.stats = {name: (RunningStats(), RunningStats())
                      for name in ("global", "local", "ref")}

    def _feats(self, images01: torch.Tensor) -> np.ndarray:
        x = images01.clamp(0.0, 1.0)
        if x.shape[1] != self.size:
            x = resize(x, self.size)
        out = self.feature_fn(x)
        return out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)

    @torch.inference_mode()
    def update(self, batch: dict, preds01: np.ndarray) -> None:
        """batch: canonical dict (image [-1,1], mask keep, ref CLIP-norm);
        preds01: (B,H,W,3) in [0,1]."""
        put = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        gt01 = put(unnormalize(np.asarray(batch["image"])))
        ref01 = put(np.clip(unnormalize_clip(np.asarray(batch["ref"])), 0, 1))
        pred01 = put(preds01)
        edit_mask = put(1.0 - np.asarray(batch["mask"]))

        real_g, fake_g = self.stats["global"]
        real_g.update(self._feats(gt01))
        fake_g.update(self._feats(pred01))

        boxes = bboxes_from_masks(edit_mask)
        gt_crop = crop_and_resize(gt01, boxes, self.size)
        pred_crop = crop_and_resize(pred01, boxes, self.size)
        real_l, fake_l = self.stats["local"]
        real_l.update(self._feats(gt_crop))
        fake_l.update(self._feats(pred_crop))

        real_r, fake_r = self.stats["ref"]
        real_r.update(self._feats(ref01))
        fake_r.update(self._feats(pred_crop))

    def compute(self) -> dict[str, float]:
        out = {}
        for name, (real, fake) in self.stats.items():
            mu1, s1 = real.finalize()
            mu2, s2 = fake.finalize()
            out[f"fid_{name}"] = frechet_distance(mu1, s1, mu2, s2)
        return out
