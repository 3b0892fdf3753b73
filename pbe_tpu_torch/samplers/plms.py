"""PLMS (pseudo linear multistep) sampler (port of ``pbe_tpu/samplers/plms.py``).

Adams-Bashforth on eps with the order ramping 1->4: step 0 is a pseudo-Heun
double model call at (t, t_next), then
    order 2: (3 e - e1) / 2
    order 3: (23 e - 16 e1 + 5 e2) / 12
    order 4: (55 e - 59 e1 + 37 e2 - 9 e3) / 24
eta must be 0. t is passed as a float32 vector; eps and the update run in
fp32 and x is rounded to the model dtype after every step. The per-step
schedule scalars are float32 values, as in the JAX sampler.
"""
from __future__ import annotations

import numpy as np
import torch

from pbe_tpu_torch.samplers.cfg import EpsFn
from pbe_tpu_torch.schedules import SamplerSchedule


def plms_sample(eps_fn: EpsFn, sched: SamplerSchedule, x_T: torch.Tensor,
                z_inpaint: torch.Tensor, mask_latent: torch.Tensor) -> torch.Tensor:
    """Full reverse PLMS chain on NHWC latents; returns x_0 (B,h,w,4)."""
    if sched.eta != 0.0:
        raise ValueError("PLMS requires eta == 0 (plms.py:25-26)")
    S = sched.num_steps
    order = np.arange(S)[::-1]
    f32 = lambda a: np.asarray(a, np.float32)
    steps = f32(sched.timesteps[order])
    # t_next is the following (smaller) timestep, clamped at the end
    steps_next = f32(sched.timesteps[np.maximum(order - 1, 0)])
    sqrt_a_t = np.sqrt(f32(sched.alphas[order]))
    a_prev = f32(sched.alphas_prev[order])
    sqrt_a_prev = np.sqrt(a_prev)
    sqrt_1m_a_prev = np.sqrt(np.float32(1.0) - a_prev)
    sqrt_1m_a = f32(sched.sqrt_one_minus_alphas[order])

    b = x_T.shape[0]
    dtype = x_T.dtype

    def x_prev_from(e: torch.Tensor, x32: torch.Tensor, i: int) -> torch.Tensor:
        pred_x0 = (x32 - float(sqrt_1m_a[i]) * e) / float(sqrt_a_t[i])
        return (float(sqrt_a_prev[i]) * pred_x0 + float(sqrt_1m_a_prev[i]) * e).to(dtype)

    def eval_eps(x: torch.Tensor, step: np.float32) -> torch.Tensor:
        t = torch.full((b,), float(step), dtype=torch.float32, device=x.device)
        return eps_fn(torch.cat([x, z_inpaint, mask_latent], dim=-1), t).float()

    x = x_T
    old: list[torch.Tensor] = []  # eps history, most recent first
    for i in range(S):
        e_t = eval_eps(x, steps[i])
        x32 = x.float()
        if i == 0:
            # pseudo improved Euler: second eval at (x_prev, t_next)
            e_next = eval_eps(x_prev_from(e_t, x32, i), steps_next[i])
            e_prime = (e_t + e_next) / 2
        elif i == 1:
            e_prime = (3 * e_t - old[0]) / 2
        elif i == 2:
            e_prime = (23 * e_t - 16 * old[0] + 5 * old[1]) / 12
        else:
            e_prime = (55 * e_t - 59 * old[0] + 37 * old[1] - 9 * old[2]) / 24
        x = x_prev_from(e_prime, x32, i)
        old = [e_t] + old[:2]
    return x
