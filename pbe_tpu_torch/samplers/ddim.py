"""DDIM sampler (port of ``pbe_tpu/samplers/ddim.py``).

Uniform-stride timestep subsequence, the 9-channel re-concat of
(x, z_inpaint, mask) at every step, CFG inside eps_fn, and eta-scaled
stochasticity (eta = 0 is deterministic). The per-step tables are the JAX
sampler's float32 values in its order (DDIM index S-1 down to 0); eps and
the update run in fp32 and x is rounded to the model dtype after each step.
"""
from __future__ import annotations

import numpy as np
import torch

from pbe_tpu_torch.samplers.cfg import EpsFn
from pbe_tpu_torch.schedules import SamplerSchedule


def ddim_sample(eps_fn: EpsFn, sched: SamplerSchedule, x_T: torch.Tensor,
                z_inpaint: torch.Tensor, mask_latent: torch.Tensor,
                generator: torch.Generator | None = None, temperature: float = 1.0,
                noise: torch.Tensor | None = None) -> torch.Tensor:
    """Full reverse DDIM chain on NHWC latents; returns x_0 (B,h,w,4).

    With eta > 0 each step adds sigma * temperature times a standard normal
    of x's shape: row p of ``noise`` (S, B, h, w, 4) for the p-th step run,
    else a draw from ``generator``; with neither it raises, as the JAX
    sampler does without a PRNG key."""
    S = sched.num_steps
    order = np.arange(S)[::-1]
    f32 = lambda a: np.asarray(a, np.float32)
    steps = f32(sched.timesteps[order])
    a_t = f32(sched.alphas[order])
    a_prev = f32(sched.alphas_prev[order])
    sigma = f32(sched.sigmas[order])
    sqrt_1m_a = f32(sched.sqrt_one_minus_alphas[order])
    sqrt_a_t = np.sqrt(a_t)
    sqrt_a_prev = np.sqrt(a_prev)
    dir_coef = np.sqrt(np.float32(1.0) - a_prev - sigma**2)

    stochastic = sched.eta > 0.0
    if stochastic and generator is None and noise is None:
        raise ValueError("eta > 0 requires a generator or injected noise")
    if noise is not None and tuple(noise.shape) != (S, *x_T.shape):
        raise ValueError(f"noise must have shape {(S, *x_T.shape)}, got {tuple(noise.shape)}")

    b = x_T.shape[0]
    dtype = x_T.dtype
    x = x_T
    for p in range(S):
        t = torch.full((b,), float(steps[p]), dtype=torch.float32, device=x.device)
        e_t = eps_fn(torch.cat([x, z_inpaint, mask_latent], dim=-1), t).float()
        pred_x0 = (x.float() - float(sqrt_1m_a[p]) * e_t) / float(sqrt_a_t[p])
        x_prev = float(sqrt_a_prev[p]) * pred_x0 + float(dir_coef[p]) * e_t
        if stochastic:
            z = noise[p].to(x.device, torch.float32) if noise is not None else torch.randn(
                x.shape, generator=generator, device=x.device, dtype=torch.float32)
            x_prev = x_prev + float(sigma[p]) * z * temperature
        x = x_prev.to(dtype)
    return x
