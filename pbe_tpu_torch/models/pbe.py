"""PaintByExample — the product model (port of ``pbe_tpu/models/pbe.py``).

  * frozen KL-VAE first stage, scale_factor=0.18215 (v1.yaml:18)
  * CLIP ViT-L/14 + mapper + final_ln exemplar encoder
  * proj_out Linear(1024->768) and the learnable unconditional vector (1,1,768)
  * eps-parameterized DDPM, 1000-step linear(sqrt) beta schedule

Submodules carry the reference state_dict roots: ``model.diffusion_model``,
``first_stage_model``, ``cond_stage_model``, ``proj_out``,
``learnable_vector``. Every method takes and returns NHWC.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from pbe_tpu_torch import config as config_lib
from pbe_tpu_torch.models.exemplar import ExemplarEncoderConfig
from pbe_tpu_torch.models.layers import Linear
from pbe_tpu_torch.models.unet import UNetConfig
from pbe_tpu_torch.models.vae import AutoencoderKLConfig, sample_diagonal_gaussian
from pbe_tpu_torch.ops.image import resize_mask
from pbe_tpu_torch.schedules import DiffusionSchedule

_DEFAULT_DDCONFIG = {
    "double_z": True, "z_channels": 4, "resolution": 256, "in_channels": 3,
    "out_ch": 3, "ch": 128, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 2,
    "attn_resolutions": [], "dropout": 0.0,
}


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another; raises rather than fall back to the CPU without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run the "
                           "port on the CPU")
    return dev


class _DiffusionWrapper(nn.Module):
    """Holds the UNet under the reference's ``model.diffusion_model`` name."""

    def __init__(self, unet: nn.Module):
        super().__init__()
        self.diffusion_model = unet


class PaintByExample(nn.Module):
    def __init__(self, unet_config: UNetConfig, vae_config: AutoencoderKLConfig,
                 cond_config: ExemplarEncoderConfig, scale_factor: float = 0.18215,
                 timesteps: int = 1000, linear_start: float = 0.00085,
                 linear_end: float = 0.0120, u_cond_percent: float = 0.2,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "plain",
                 remat: bool | None = None):
        super().__init__()
        self.unet_config = unet_config
        self.vae_config = vae_config
        self.cond_config = cond_config
        self.scale_factor = scale_factor
        self.u_cond_percent = u_cond_percent
        self.dtype = dtype
        self.schedule = DiffusionSchedule.create(
            timesteps=timesteps, beta_schedule="linear",
            linear_start=linear_start, linear_end=linear_end)
        # the q-sample and loss-weight tables of the training step, on the
        # model's device (not part of the state_dict)
        for name in ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                     "lvlb_weights"):
            self.register_buffer(name, torch.as_tensor(getattr(self.schedule, name),
                                                       dtype=torch.float32),
                                 persistent=False)
        self.model = _DiffusionWrapper(unet_config.build(dtype, attn_impl, remat))
        self.first_stage_model = vae_config.build(dtype, attn_impl)
        self.cond_stage_model = cond_config.build(dtype)
        self.proj_out = Linear(1024, 768)
        self.learnable_vector = nn.Parameter(torch.zeros(1, 1, 768))

    @property
    def device(self) -> torch.device:
        return self.learnable_vector.device

    @property
    def latent_downsample(self) -> int:
        """Image->latent spatial factor (8 for the v1 VAE)."""
        return 2 ** (len(self.vae_config.ddconfig.get("ch_mult", (1, 2, 4, 4))) - 1)

    # ---- first stage -----------------------------------------------------
    def encode_first_stage(self, x: torch.Tensor,
                           generator: torch.Generator | None = None) -> torch.Tensor:
        """Scaled latent of x (NHWC in [-1,1]); the posterior mode when
        generator is None, else a sample drawn from it."""
        mean, logvar = self.first_stage_model.encode(x)
        z = mean if generator is None else sample_diagonal_gaussian(generator, mean, logvar)
        return self.scale_factor * z

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.first_stage_model.decode(z / self.scale_factor)

    def prepare_latents(self, image: torch.Tensor, inpaint_image: torch.Tensor,
                        mask: torch.Tensor, generator: torch.Generator | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(z, z_inpaint, mask_latent) of the training step: image and
        inpaint_image NHWC in [-1,1], mask (B,H,W,1) with 1 = keep, resized
        bilinearly to the latent grid. Posterior modes when generator is
        None, else samples drawn from it."""
        z = self.encode_first_stage(image, generator)
        z_inpaint = self.encode_first_stage(inpaint_image, generator)
        return z, z_inpaint, resize_mask(mask, z.shape[1:3]).to(z.dtype)

    # ---- conditioning ----------------------------------------------------
    def get_conditioning(self, ref: torch.Tensor) -> torch.Tensor:
        """ref (B,224,224,3) CLIP-normalized -> (B,1,768) context token."""
        return self.proj_out(self.cond_stage_model(ref))

    def uncond_vector(self, batch: int) -> torch.Tensor:
        return self.learnable_vector.to(self.dtype).expand(batch, 1, 768)

    # ---- diffusion backbone ----------------------------------------------
    def apply_model(self, x9: torch.Tensor, t: torch.Tensor,
                    context: torch.Tensor) -> torch.Tensor:
        """UNet eps on the 9-channel latent (NHWC)."""
        return self.model.diffusion_model(x9, t, context)


@dataclasses.dataclass
class PaintByExampleConfig:
    """configs/v1.yaml ``model.params``-compatible constructor."""

    unet_config: Any = None
    first_stage_config: Any = None
    cond_stage_config: Any = None
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    timesteps: int = 1000
    num_timesteps_cond: int = 1
    log_every_t: int = 200
    first_stage_key: str = "inpaint"
    cond_stage_key: str = "image"
    image_size: int = 64
    channels: int = 4
    cond_stage_trainable: bool = True
    conditioning_key: str = "crossattn"
    monitor: str = "val/loss_simple_ema"
    u_cond_percent: float = 0.2
    scale_factor: float = 0.18215
    use_ema: bool = False
    scheduler_config: dict | None = None
    base_learning_rate: float = 1.0e-05

    @staticmethod
    def _sub(cfg, default):
        if cfg is None:
            return default()
        if isinstance(cfg, dict):
            return config_lib.instantiate_from_config(cfg)
        return cfg

    def build(self, dtype: torch.dtype = torch.float32, attn_impl: str = "plain",
              device: str | torch.device | None = "cuda",
              remat: bool | None = None) -> PaintByExample:
        """The model with its parameters allocated on ``device`` (see
        :func:`resolve_device`), not yet initialized. ``remat=None`` takes
        the UNet config's ``use_checkpoint``."""
        with torch.device(resolve_device(device)):
            return PaintByExample(
                unet_config=self._sub(self.unet_config, UNetConfig),
                vae_config=self._sub(self.first_stage_config,
                                     lambda: AutoencoderKLConfig(dict(_DEFAULT_DDCONFIG))),
                cond_config=self._sub(self.cond_stage_config, ExemplarEncoderConfig),
                scale_factor=self.scale_factor, timesteps=self.timesteps,
                linear_start=self.linear_start, linear_end=self.linear_end,
                u_cond_percent=self.u_cond_percent, dtype=dtype, attn_impl=attn_impl,
                remat=remat,
            )


def build_from_yaml(path: str, dtype: torch.dtype = torch.float32,
                    attn_impl: str = "plain",
                    device: str | torch.device | None = "cuda",
                    remat: bool | None = None) -> tuple[PaintByExample, dict]:
    """Load a configs/v1.yaml-style file and build the model on ``device``
    -> (model, raw config)."""
    raw = config_lib.load_config(path)
    model_cfg = config_lib.instantiate_from_config(raw["model"])
    return model_cfg.build(dtype=dtype, attn_impl=attn_impl, device=device,
                           remat=remat), raw
