"""DDIM sampler (port of ``pbe_tpu/samplers/ddim.py``).

Uniform-stride timestep subsequence, the 9-channel re-concat of
(x, z_inpaint, mask) at every step, CFG inside eps_fn, and eta-scaled
stochasticity (eta = 0 is deterministic). The per-step tables are the JAX
sampler's float32 values in its order (DDIM index S-1 down to 0); eps and
the update run in fp32 and x is rounded to the model dtype after each step.
Every step is :func:`ddim_step`, which takes its position as a tensor and
gathers its scalars from those tables, so the live chain and a frozen step
program (``pipelines/export.py``) compute the same thing. The chain asks
the host for nothing: the tables are made once per schedule and the step
positions are views of one ``arange``.
"""
from __future__ import annotations

import numpy as np
import torch

from pbe_tpu_torch.samplers import divide, schedule_tables
from pbe_tpu_torch.samplers.cfg import EpsFn
from pbe_tpu_torch.schedules import SamplerSchedule


def ddim_tables(sched: SamplerSchedule, device: torch.device | str) -> dict[str, torch.Tensor]:
    """The per-step float32 tables, indexed by step position p = 0..S-1:
    t, sqrt(a_t) and its reciprocal, sqrt(a_prev), sqrt(1 - a_prev -
    sigma^2), sigma and sqrt(1 - a_t); made once per schedule and device."""
    return schedule_tables("ddim", sched, device, _host_tables)


def _host_tables(sched: SamplerSchedule) -> dict[str, np.ndarray]:
    order = np.arange(sched.num_steps)[::-1]
    f32 = lambda a: np.asarray(a, np.float32)
    a_prev, sigma = f32(sched.alphas_prev[order]), f32(sched.sigmas[order])
    sqrt_a_t = np.sqrt(f32(sched.alphas[order]))
    return {"t": f32(sched.timesteps[order]),
            "sqrt_a_t": sqrt_a_t, "inv_sqrt_a_t": np.float32(1.0) / sqrt_a_t,
            "sqrt_a_prev": np.sqrt(a_prev),
            "dir_coef": np.sqrt(np.float32(1.0) - a_prev - sigma**2),
            "sigma": sigma,
            "sqrt_1m_a": f32(sched.sqrt_one_minus_alphas[order])}


def ddim_step(eps_fn: EpsFn, tables: dict[str, torch.Tensor], p: torch.Tensor,
              x: torch.Tensor, z_inpaint: torch.Tensor, mask_latent: torch.Tensor,
              z: torch.Tensor | None = None, temperature: float = 1.0) -> torch.Tensor:
    """One DDIM step at position ``p`` (a 0-d int64 tensor) -> x_prev. ``z``,
    the step's standard normals of x's shape, adds sigma * temperature * z
    (eta > 0); None is the deterministic step."""
    # a gather, not tables[name][p]: indexing by a tensor reads its value
    # on the host (.item()), which a traced step program cannot do
    at = lambda name: tables[name].index_select(0, p.reshape(1)).reshape(())
    t = at("t").reshape(1).expand(x.shape[0]).contiguous()
    e_t = eps_fn(torch.cat([x, z_inpaint, mask_latent], dim=-1), t).float()
    pred_x0 = divide(x.float() - at("sqrt_1m_a") * e_t, at, "sqrt_a_t")
    x_prev = at("sqrt_a_prev") * pred_x0 + at("dir_coef") * e_t
    if z is not None:
        x_prev = x_prev + at("sigma") * z.to(x.device, torch.float32) * temperature
    return x_prev.to(x.dtype)


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
    stochastic = sched.eta > 0.0
    if stochastic and generator is None and noise is None:
        raise ValueError("eta > 0 requires a generator or injected noise")
    if noise is not None and tuple(noise.shape) != (S, *x_T.shape):
        raise ValueError(f"noise must have shape {(S, *x_T.shape)}, got {tuple(noise.shape)}")

    tables = ddim_tables(sched, x_T.device)
    x = x_T
    for p, p_t in enumerate(torch.arange(S, device=x_T.device)):
        z = None
        if stochastic:
            z = noise[p] if noise is not None else torch.randn(
                x.shape, generator=generator, device=x.device, dtype=torch.float32)
        x = ddim_step(eps_fn, tables, p_t, x, z_inpaint, mask_latent, z, temperature)
    return x
