"""Full-chain DDPM ancestral sampler (port of
``pbe_tpu/samplers/ddpm_ancestral.py``).

Eps-parameterized posterior sampling over all T steps with optional x0
clipping. Not on the PBE fast path (DDIM and PLMS are); the edit pipeline
runs it for ``sampler="ddpm"``.
"""
from __future__ import annotations

import numpy as np
import torch

from pbe_tpu_torch.samplers.cfg import EpsFn
from pbe_tpu_torch.schedules import DiffusionSchedule


def ddpm_ancestral_sample(eps_fn: EpsFn, sched: DiffusionSchedule, x_T: torch.Tensor,
                          z_inpaint: torch.Tensor, mask_latent: torch.Tensor,
                          generator: torch.Generator | None = None,
                          clip_denoised: bool = False,
                          noise: torch.Tensor | None = None) -> torch.Tensor:
    """Reverse the full T-step chain; returns x_0 latents (B,h,w,4).

    Step p (t = T-1-p) adds exp(log_var[t] / 2) times a standard normal,
    row p of ``noise`` (T, B, h, w, 4) or a draw from ``generator``; the
    last step (t = 0) adds none and draws none."""
    T = sched.num_timesteps
    if generator is None and noise is None:
        raise ValueError("the ancestral sampler needs a generator or injected noise")
    if noise is not None and tuple(noise.shape) != (T, *x_T.shape):
        raise ValueError(f"noise must have shape {(T, *x_T.shape)}, got {tuple(noise.shape)}")
    f32 = lambda a: np.asarray(a, np.float32)
    sqrt_recip = f32(sched.sqrt_recip_alphas_cumprod)
    sqrt_recipm1 = f32(sched.sqrt_recipm1_alphas_cumprod)
    coef1 = f32(sched.posterior_mean_coef1)
    coef2 = f32(sched.posterior_mean_coef2)
    std = np.exp(np.float32(0.5) * f32(sched.posterior_log_variance_clipped))

    b = x_T.shape[0]
    dtype = x_T.dtype
    x = x_T
    for p, t in enumerate(range(T - 1, -1, -1)):
        tt = torch.full((b,), float(t), dtype=torch.float32, device=x.device)
        eps = eps_fn(torch.cat([x, z_inpaint, mask_latent], dim=-1), tt).float()
        x32 = x.float()
        x0 = float(sqrt_recip[t]) * x32 - float(sqrt_recipm1[t]) * eps
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        x_new = float(coef1[t]) * x0 + float(coef2[t]) * x32
        if t > 0:
            z = noise[p].to(x.device, torch.float32) if noise is not None else torch.randn(
                x.shape, generator=generator, device=x.device, dtype=torch.float32)
            x_new = x_new + float(std[t]) * z
        x = x_new.to(dtype)
    return x
