"""End-to-end exemplar-guided edit (port of ``pbe_tpu/pipelines/inference.py``).

One edit: VAE-encode the masked source, encode the exemplar, run the
S-step CFG sampler (PLMS: S+1 UNet calls at doubled batch, DDIM: S, DDPM:
the full T-step chain; scale 1 runs the UNet once at batch B; with
``tiling``, every UNet call over latent crops in one batch), VAE-decode,
optionally paste the original pixels back outside the mask, then [0,1]
float32, uint8 or the sampled latent. NHWC numpy in and out, like the JAX
pipeline. PyTorch runs it eagerly on the model's device.
"""
from __future__ import annotations

import numpy as np
import torch

from pbe_tpu_torch.models.pbe import PaintByExample
from pbe_tpu_torch.models.vae_asym import paste_back as paste_back_fn
from pbe_tpu_torch.ops import quant
from pbe_tpu_torch.ops.image import resize_mask
from pbe_tpu_torch.ops.tiling import TilingSpec, tiled_apply
from pbe_tpu_torch.samplers.cfg import make_cfg_eps_fn
from pbe_tpu_torch.samplers.ddim import ddim_sample
from pbe_tpu_torch.samplers.ddpm_ancestral import ddpm_ancestral_sample
from pbe_tpu_torch.samplers.plms import plms_sample
from pbe_tpu_torch.schedules import SamplerSchedule


class PendingOutput:
    """An edit's result (the ``block=False`` handle). On the card its copy
    to pinned host memory is issued at once, behind the edit's last launch,
    and an event recorded after it: ``is_ready()`` polls that event without
    waiting, as a JAX array's does, and ``np.asarray`` waits for it alone,
    not for work issued on the stream later (the next batch). Indexing
    (``out[:n]``) gives a handle on that part with the same event."""

    def __init__(self, tensor: torch.Tensor, done: "torch.cuda.Event | None" = None):
        if done is None and tensor.device.type == "cuda":
            host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            host.copy_(tensor, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(tensor.device))
            tensor = host
        self.tensor = tensor
        self._done = done

    def __getitem__(self, idx) -> "PendingOutput":
        return PendingOutput(self.tensor[idx], self._done)

    def is_ready(self) -> bool:
        return self._done is None or self._done.query()

    def __array__(self, dtype=None, copy=None):
        if self._done is not None:
            self._done.synchronize()
        a = self.tensor.numpy()
        return a if dtype is None else a.astype(dtype)


class EditBody:
    """The tensor-level edit of one configuration (sampler, steps, eta,
    guided or not, paste-back, output), shared by the live edit and the
    frozen programs of ``pipelines/export.py``. Inputs are float32 tensors on
    the model's device, as the caller's arrays: the body rounds them to the
    model's dtype where the model reads them (and keeps the caller's fp32
    pixels for paste-back). :meth:`encode`, :meth:`eps_fn`, the samplers'
    step functions and :meth:`finish` are the pieces; the live edit runs
    them through :meth:`sample`, a frozen program as its prologue, step and
    epilogue."""

    def __init__(self, pipeline: "EditPipeline", *, steps: int, sampler: str, eta: float,
                 cfg: bool, paste_back: int | None, output: str = "float32"):
        self.model = pipeline.model
        self.apply_fn = pipeline._apply_fn()
        self.sampler, self.cfg, self.output = sampler, bool(cfg), output
        self.paste_back = paste_back
        self.sched = (SamplerSchedule.create(self.model.schedule, int(steps), eta=float(eta))
                      if sampler in ("plms", "ddim") else None)

    def encode(self, image: torch.Tensor, mask: torch.Tensor, ref: torch.Tensor,
               generator: torch.Generator | None = None, eps: torch.Tensor | None = None):
        """(z_inpaint, mask latent, conditioning) of an edit: the masked
        source's posterior mode, or its sample by ``generator`` or the
        standard normals ``eps``."""
        model, dt = self.model, self.model.dtype
        image, mask = image.to(dt), mask.to(dt)
        z_inpaint = model.encode_first_stage(image * mask, generator, eps)
        m_lat = resize_mask(mask, z_inpaint.shape[1:3]).to(z_inpaint.dtype)
        return z_inpaint, m_lat, model.get_conditioning(ref.to(dt))

    def eps_fn(self, c: torch.Tensor, scale: float | torch.Tensor):
        return make_cfg_eps_fn(self.apply_fn, c, self.model.uncond_vector(c.shape[0]), scale,
                               self.cfg)

    def sample(self, x_t, z_inpaint, m_lat, c, scale, generator=None, noise=None):
        """The whole chain from x_t (model dtype) -> x_0."""
        eps_fn = self.eps_fn(c, scale)
        if self.sampler == "ddpm":
            return ddpm_ancestral_sample(eps_fn, self.model.schedule, x_t, z_inpaint, m_lat,
                                         generator=generator, noise=noise)
        if self.sampler == "plms":
            return plms_sample(eps_fn, self.sched, x_t, z_inpaint, m_lat)
        return ddim_sample(eps_fn, self.sched, x_t, z_inpaint, m_lat, generator=generator,
                           noise=noise)

    def finish(self, x0: torch.Tensor, image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x_0 -> the output: the float32 latent, or the decode in [0,1]
        (pasted back against the caller's fp32 pixels), as uint8 if asked."""
        if self.output == "latent":
            return x0.float()
        img = self.model.decode_first_stage(x0)
        out = ((img.float() + 1.0) / 2.0).clamp(0.0, 1.0)
        if self.paste_back is not None:
            # against the caller's fp32 pixels, so every mask==1 pixel is
            # the source's exactly, also when the model runs in bf16
            out = paste_back_fn(out, (image + 1.0) / 2.0, mask, feather=int(self.paste_back))
        if self.output == "uint8":
            # round half to even, as the JAX pipeline and to_uint8 do
            out = torch.round(out * 255.0).to(torch.uint8)
        return out


class EditPipeline:
    """Holds a PaintByExample model (already on its device, in eval mode)."""

    def __init__(self, model: PaintByExample, quantize: str | None = None,
                 tiling: TilingSpec | None = None, quant_scales: tuple | None = None):
        # tiling: run every UNet eps call of an edit over latent crops
        # (ks/stride in latent pixels; ops/tiling.py), all crops at once.
        # "int8": every edit runs the UNet's eligible matmuls and convs in
        # w8a8 (ops/quant.py); quant_scales: calibrated static scales from
        # calibrate_int8() (no runtime amax)
        if quant_scales is not None and quantize != "int8":
            raise ValueError("quant_scales requires quantize='int8'")
        self.model = model.eval()
        self.tiling = tiling
        self.quantize = quantize
        self.quant_scales = quant_scales

    @property
    def ref_size(self) -> int:
        """Exemplar side length the CLIP tower expects (224 for ViT-L/14)."""
        clip = self.model.cond_config.clip
        return clip.image_size if clip is not None else 224

    def shard(self, mesh=None) -> "EditPipeline":
        raise NotImplementedError("multi-card serving is not ported yet (ROADMAP "
                                  "Queue 1, item 11)")

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
        returns a :class:`PendingOutput` without waiting for the device.
        A pipeline built with ``quantize="int8"`` runs the edit inside
        ``quant.quantized`` (with its ``quant_scales``, if any)."""
        qkw = {"static": self.quant_scales} if self.quant_scales else {}
        with quant.quantized(self.quantize, **qkw):
            return self._edit_batch(image, mask, ref, steps=steps, scale=scale,
                                    sampler=sampler, eta=eta, seed=seed, x_T=x_T,
                                    paste_back=paste_back, det_first_stage=det_first_stage,
                                    output=output, block=block, noise=noise)

    def _edit_batch(self, image, mask, ref, *, steps, scale, sampler, eta, seed, x_T,
                    paste_back, det_first_stage, output, block, noise):
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
        as_t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev)
        if x_T is None:
            x_t = torch.randn((b, h // f, w // f, 4), generator=gen, device=dev).to(dt)
        else:
            x_t = as_t(x_T).to(dt)
        body = EditBody(self, steps=steps, sampler=sampler, eta=eta, cfg=float(scale) != 1.0,
                        paste_back=paste_back, output=output)
        image_t, mask_t = as_t(image), as_t(mask)
        z_inpaint, m_lat, c = body.encode(image_t, mask_t, as_t(ref),
                                          None if det_first_stage else gen)
        x0 = body.sample(x_t, z_inpaint, m_lat, c, float(scale), gen,
                         None if noise is None else as_t(noise))
        out = body.finish(x0, image_t, mask_t)
        if not block:
            return PendingOutput(out)
        return out.cpu().numpy()

    def _apply_fn(self):
        """The UNet eps call of an edit: the model's, or with ``tiling`` the
        model's over latent crops. The crops are stacked crop-major into the
        batch, so t and ctx repeat whole-batch blocks (``Tensor.repeat``, as
        JAX's ``jnp.tile``); CFG's doubling happens outside, so a tiled CFG
        call runs at batch 2B * L."""
        apply_model, spec = self.model.apply_model, self.tiling
        if spec is None:
            return apply_model

        def apply_fn(x9, t, ctx):
            def inner(patches):
                reps = patches.shape[0] // x9.shape[0]
                return apply_model(patches, t.repeat(reps), ctx.repeat(reps, 1, 1))

            return tiled_apply(inner, x9, spec)

        return apply_fn

    def edit(self, image: np.ndarray, mask: np.ndarray, ref: np.ndarray, **kw) -> np.ndarray:
        """Single-example convenience; HWC in, HWC out."""
        out = self.edit_batch(image[None], mask[None], ref[None], **kw)
        return out[0]

    @torch.inference_mode()
    def calibrate_int8(self, image: np.ndarray, mask: np.ndarray, ref: np.ndarray,
                       n_t: int = 8, seed: int = 0, *, draws=None) -> tuple:
        """Calibrate static w8a8 scales on representative edit inputs (NHWC,
        shaped like a serving batch) -> the tuple for
        ``EditPipeline(quantize="int8", quant_scales=...)``.

        Records each eligible op's activation and weight amax in one
        CFG-doubled UNet call at each of ``n_t`` timesteps spread over the
        schedule, on x_t drawn from q(x_t | z0) around the encoded source:
        the statistics the sampler's calls see. The random draws of call i,
        standard normals of the latent's shape (the source's posterior
        sample, the masked source's, then the forward noise), come from a
        generator seeded with ``seed + i``, or from ``draws[i]``, a
        (eps_z, eps_z_inpaint, noise) triple of NHWC arrays."""
        model = self.model
        dev, dt = model.device, model.dtype
        sched = model.schedule
        as_t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev, dt)
        image_t, mask_t, ref_t = as_t(image), as_t(mask), as_t(ref)
        # the encoder's posteriors and the conditioning do not depend on t
        posteriors = [model.first_stage_model.encode(x) for x in (image_t, image_t * mask_t)]
        c = model.get_conditioning(ref_t)
        ctx2 = torch.cat([model.uncond_vector(image_t.shape[0]).to(c.dtype), c], dim=0)
        n_steps = len(sched.alphas_cumprod)
        recs = []
        for i, t in enumerate(np.linspace(0, n_steps - 1, n_t).round().astype(np.int32)):
            shape = posteriors[0][0].shape
            if draws is None:
                gen = torch.Generator(device=dev).manual_seed(int(seed) + i)
                eps = [torch.randn(shape, generator=gen, device=dev).to(dt) for _ in range(3)]
            else:
                eps = [as_t(a) for a in draws[i]]
            z, z_inpaint = (model.scale_factor * (mean + torch.exp(0.5 * logvar) * e)
                            for (mean, logvar), e in zip(posteriors, eps))
            m = resize_mask(mask_t, z.shape[1:3]).to(z.dtype)
            coef = lambda table: torch.tensor(np.float32(table[t]), device=dev).to(dt)
            x_t = coef(sched.sqrt_alphas_cumprod) * z + coef(
                sched.sqrt_one_minus_alphas_cumprod) * eps[2]
            x9 = torch.cat([x_t, z_inpaint, m], dim=-1)
            t2 = torch.full((2 * x9.shape[0],), float(t), device=dev)
            with quant.calibration() as col:
                model.apply_model(torch.cat([x9, x9], dim=0), t2, ctx2)
            recs.append(col.records)
        return quant.scales_from_records(recs)
