"""End-to-end exemplar-guided edit (port of ``pbe_tpu/pipelines/inference.py``).

One edit: VAE-encode the masked source, encode the exemplar, run the
S-step CFG sampler (PLMS: S+1 UNet calls at doubled batch, DDIM: S, DDPM:
the full T-step chain; scale 1 runs the UNet once at batch B), VAE-decode,
optionally paste the original pixels back outside the mask, then [0,1]
float32, uint8 or the sampled latent. NHWC numpy in and out, like the JAX
pipeline. PyTorch runs it eagerly on the model's device.
"""
from __future__ import annotations

import numpy as np
import torch

from pbe_tpu_torch.models.pbe import PaintByExample
from pbe_tpu_torch.models.vae_asym import paste_back as paste_back_fn
from pbe_tpu_torch.ops.image import resize_mask
from pbe_tpu_torch.samplers.cfg import make_cfg_eps_fn
from pbe_tpu_torch.samplers.ddim import ddim_sample
from pbe_tpu_torch.samplers.ddpm_ancestral import ddpm_ancestral_sample
from pbe_tpu_torch.samplers.plms import plms_sample
from pbe_tpu_torch.schedules import SamplerSchedule


class PendingOutput:
    """An edit's device result (the ``block=False`` handle): ``is_ready()``
    says without waiting whether the device has made it, as a JAX array's
    does; ``np.asarray`` waits for it and copies it to the host."""

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        # recorded on the current stream right after the tensor is made
        self._done = None
        if tensor.device.type == "cuda":
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(tensor.device))

    def is_ready(self) -> bool:
        return self._done is None or self._done.query()

    def __array__(self, dtype=None, copy=None):
        a = self.tensor.cpu().numpy()
        return a if dtype is None else a.astype(dtype)


class EditPipeline:
    """Holds a PaintByExample model (already on its device, in eval mode)."""

    def __init__(self, model: PaintByExample, quantize: str | None = None, tiling=None):
        if quantize is not None:
            raise NotImplementedError("int8 serving is not ported yet (ROADMAP Queue 1, "
                                      "item 9)")
        if tiling is not None:
            raise NotImplementedError("the tiled pipeline is not ported yet (ROADMAP "
                                      "Queue 1, item 13)")
        self.model = model.eval()

    @property
    def ref_size(self) -> int:
        """Exemplar side length the CLIP tower expects (224 for ViT-L/14)."""
        clip = self.model.cond_config.clip
        return clip.image_size if clip is not None else 224

    def shard(self, mesh=None) -> "EditPipeline":
        raise NotImplementedError("multi-card serving is not ported yet (ROADMAP "
                                  "Queue 1, items 8 and 11)")

    @torch.inference_mode()
    def edit_batch(self, image: np.ndarray, mask: np.ndarray, ref: np.ndarray, *,
                   steps: int = 50, scale: float = 5.0, sampler: str = "plms",
                   eta: float = 0.0, seed: int = 42, x_T: np.ndarray | None = None,
                   paste_back: int | None = None, det_first_stage: bool = False,
                   output: str = "float32", block: bool = True,
                   noise: np.ndarray | None = None):
        """image (B,H,W,3) in [-1,1]; mask (B,H,W,1) 1=keep; ref (B,224,224,3)
        CLIP-normalized. Returns (B,H,W,3) float32 in [0,1], uint8 in
        [0,255] with ``output="uint8"``, or the (B,H/8,W/8,4) float32 latent
        with ``output="latent"``.

        sampler: "plms" (eta must be 0), "ddim" (stochastic when eta > 0) or
        "ddpm" (the full T-step ancestral chain; ``steps`` is ignored).
        paste_back: None (the full decode) or a feather radius in pixels:
        the original pixels are composited back where mask==1, bit-exact,
        with a feathered seam into the edit (0 = hard seam).

        Random draws come from one ``torch.Generator`` on the model's device
        seeded with ``seed``, in this order: x_T (unless injected), the
        encoder's posterior sample (unless ``det_first_stage``), then the
        sampler's per-step noise (DDIM with eta > 0, DDPM) unless ``noise``
        injects those standard normals, one row a step. ``block=False``
        returns a :class:`PendingOutput` without waiting for the device."""
        if sampler not in ("plms", "ddim", "ddpm"):
            raise ValueError(f"unknown sampler {sampler!r}")
        if output not in ("float32", "uint8", "latent"):
            raise ValueError(f"output must be 'float32', 'uint8' or 'latent', got {output!r}")
        model = self.model
        dev, dt = model.device, model.dtype
        b, h, w, _ = image.shape
        f = model.latent_downsample
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        # a copy with C strides: a view such as ref[None] has stride 0 on
        # its batch axis, and on the card the bf16 result depended on the
        # strides (the convs choose their layout and algorithm by them)
        as_t = lambda a, dtype=dt: torch.from_numpy(np.array(a, np.float32)).to(dev, dtype)
        if x_T is None:
            x_t = torch.randn((b, h // f, w // f, 4), generator=gen, device=dev).to(dt)
        else:
            x_t = as_t(x_T)
        image_t, mask_t, ref_t = as_t(image), as_t(mask), as_t(ref)

        z_inpaint = model.encode_first_stage(image_t * mask_t,
                                             None if det_first_stage else gen)
        m_lat = resize_mask(mask_t, z_inpaint.shape[1:3]).to(z_inpaint.dtype)
        c = model.get_conditioning(ref_t)
        eps_fn = make_cfg_eps_fn(model.apply_model, c, model.uncond_vector(b), float(scale))
        noise_t = None if noise is None else as_t(noise, torch.float32)
        if sampler == "ddpm":
            x0 = ddpm_ancestral_sample(eps_fn, model.schedule, x_t, z_inpaint, m_lat,
                                       generator=gen, noise=noise_t)
        else:
            sched = SamplerSchedule.create(model.schedule, int(steps), eta=float(eta))
            if sampler == "plms":
                x0 = plms_sample(eps_fn, sched, x_t, z_inpaint, m_lat)
            else:
                x0 = ddim_sample(eps_fn, sched, x_t, z_inpaint, m_lat,
                                 generator=gen, noise=noise_t)

        if output == "latent":
            out = x0.float()
        else:
            img = model.decode_first_stage(x0)
            out = ((img.float() + 1.0) / 2.0).clamp(0.0, 1.0)
            if paste_back is not None:
                # against the caller's fp32 pixels, so every mask==1 pixel
                # is the source's exactly, also when the model runs in bf16
                orig01 = (as_t(image, torch.float32) + 1.0) / 2.0
                out = paste_back_fn(out, orig01, as_t(mask, torch.float32),
                                    feather=int(paste_back))
            if output == "uint8":
                # round half to even, as the JAX pipeline and to_uint8 do
                out = torch.round(out * 255.0).to(torch.uint8)
        if not block:
            return PendingOutput(out)
        return out.cpu().numpy()

    def edit(self, image: np.ndarray, mask: np.ndarray, ref: np.ndarray, **kw) -> np.ndarray:
        """Single-example convenience; HWC in, HWC out."""
        out = self.edit_batch(image[None], mask[None], ref[None], **kw)
        return out[0]
