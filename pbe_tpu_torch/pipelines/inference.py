"""End-to-end exemplar-guided edit (port of ``pbe_tpu/pipelines/inference.py``).

One edit: VAE-encode the masked source, encode the exemplar, run the
S-step CFG PLMS chain (S+1 UNet calls at doubled batch), VAE-decode, then
[0,1] float32, uint8 or the sampled latent. NHWC numpy in and out, like the
JAX pipeline. PyTorch runs it eagerly on the model's device.
"""
from __future__ import annotations

import numpy as np
import torch

from pbe_tpu_torch.models.pbe import PaintByExample
from pbe_tpu_torch.ops.image import resize_mask
from pbe_tpu_torch.samplers.cfg import make_cfg_eps_fn
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
                   output: str = "float32", block: bool = True):
        """image (B,H,W,3) in [-1,1]; mask (B,H,W,1) 1=keep; ref (B,224,224,3)
        CLIP-normalized. Returns (B,H,W,3) float32 in [0,1], uint8 in
        [0,255] with ``output="uint8"``, or the (B,H/8,W/8,4) float32 latent
        with ``output="latent"``. ``x_T`` injects the initial noise; else it
        and the encoder's posterior sample (unless ``det_first_stage``) are
        drawn from a ``torch.Generator`` seeded with ``seed``. ``block=False``
        returns a :class:`PendingOutput` without waiting for the device."""
        if sampler != "plms":
            raise NotImplementedError(f"sampler {sampler!r} is not ported yet (ROADMAP "
                                      "Queue 1, item 3: DDIM and DDPM)")
        if paste_back is not None:
            raise NotImplementedError("paste_back is not ported yet (ROADMAP Queue 1, "
                                      "item 4: vae_asym)")
        if output not in ("float32", "uint8", "latent"):
            raise ValueError(f"output must be 'float32', 'uint8' or 'latent', got {output!r}")
        model = self.model
        dev, dt = model.device, model.dtype
        b, h, w, _ = image.shape
        f = model.latent_downsample
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        as_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)
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
        sched = SamplerSchedule.create(model.schedule, int(steps), eta=float(eta))
        x0 = plms_sample(eps_fn, sched, x_t, z_inpaint, m_lat)

        if output == "latent":
            out = x0.float()
        else:
            img = model.decode_first_stage(x0)
            out = ((img.float() + 1.0) / 2.0).clamp(0.0, 1.0)
            if output == "uint8":
                # round half to even, as the JAX pipeline and to_uint8 do
                out = torch.round(out * 255.0).to(torch.uint8)
        if not block:
            return PendingOutput(out)
        return out.cpu().numpy()
