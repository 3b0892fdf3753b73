"""PLMS (pseudo linear multistep) sampler (port of ``pbe_tpu/samplers/plms.py``).

Adams-Bashforth on eps with the order ramping 1->4: step 0 is a pseudo-Heun
double model call at (t, t_next), then
    order 2: (3 e - e1) / 2
    order 3: (23 e - 16 e1 + 5 e2) / 12
    order 4: (55 e - 59 e1 + 37 e2 - 9 e3) / 24
eta must be 0. t is passed as a float32 vector; eps and the update run in
fp32 and x is rounded to the model dtype after every step.

As in the JAX sampler, steps 0-2 are peeled and steps 3.. run one uniform
AB4 body on a most-recent-first eps history of fixed shape. Every step is
:func:`plms_step`, which takes its index as a tensor and gathers its
schedule scalars from the float32 tables of :func:`plms_tables`, so the
live chain and a frozen step program (``pipelines/export.py``) compute the
same thing. The chain asks the host for nothing: the tables are made once
per schedule and the step indices are views of one ``arange``.
"""
from __future__ import annotations

import numpy as np
import torch

from pbe_tpu_torch.samplers import divide, schedule_tables
from pbe_tpu_torch.samplers.cfg import EpsFn
from pbe_tpu_torch.schedules import SamplerSchedule

PEELED = 3  # steps 0-2 ramp the order; steps 3.. are the AB4 body


def plms_tables(sched: SamplerSchedule, device: torch.device | str) -> dict[str, torch.Tensor]:
    """The per-step float32 tables, indexed by step position i = 0..S-1
    (DDIM index S-1 down to 0): t, the following t (clamped at the end),
    sqrt(a_t) and its reciprocal, sqrt(a_prev), sqrt(1 - a_prev),
    sqrt(1 - a_t); made once per schedule and device."""
    if sched.eta != 0.0:
        raise ValueError("PLMS requires eta == 0 (plms.py:25-26)")
    return schedule_tables("plms", sched, device, _host_tables)


def _host_tables(sched: SamplerSchedule) -> dict[str, np.ndarray]:
    order = np.arange(sched.num_steps)[::-1]
    f32 = lambda a: np.asarray(a, np.float32)
    a_prev = f32(sched.alphas_prev[order])
    sqrt_a_t = np.sqrt(f32(sched.alphas[order]))
    return {"t": f32(sched.timesteps[order]),
            "t_next": f32(sched.timesteps[np.maximum(order - 1, 0)]),
            "sqrt_a_t": sqrt_a_t, "inv_sqrt_a_t": np.float32(1.0) / sqrt_a_t,
            "sqrt_a_prev": np.sqrt(a_prev),
            "sqrt_1m_a_prev": np.sqrt(np.float32(1.0) - a_prev),
            "sqrt_1m_a": f32(sched.sqrt_one_minus_alphas[order])}


def plms_step(eps_fn: EpsFn, tables: dict[str, torch.Tensor], i: torch.Tensor,
              x: torch.Tensor, history: tuple[torch.Tensor, ...], z_inpaint: torch.Tensor,
              mask_latent: torch.Tensor) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
    """One PLMS step at position ``i`` (a 0-d int64 tensor) -> (x_prev, the
    new history). ``history`` holds the eps of the earlier steps, most
    recent first, at most 3; its length picks the order: 0 is step 0's
    Heun double call, 1 and 2 the ramp, 3 the uniform AB4 body."""
    # a gather, not tables[name][i]: indexing by a tensor reads its value
    # on the host (.item()), which a traced step program cannot do
    at = lambda name: tables[name].index_select(0, i.reshape(1)).reshape(())
    b, dtype = x.shape[0], x.dtype

    def eval_eps(x_in: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return eps_fn(torch.cat([x_in, z_inpaint, mask_latent], dim=-1),
                      t.reshape(1).expand(b).contiguous()).float()

    def x_prev_from(e: torch.Tensor, x32: torch.Tensor) -> torch.Tensor:
        pred_x0 = divide(x32 - at("sqrt_1m_a") * e, at, "sqrt_a_t")
        return (at("sqrt_a_prev") * pred_x0 + at("sqrt_1m_a_prev") * e).to(dtype)

    e_t = eval_eps(x, at("t"))
    x32 = x.float()
    if not history:
        # pseudo improved Euler: second eval at (x_prev, t_next)
        e_next = eval_eps(x_prev_from(e_t, x32), at("t_next"))
        e_prime = (e_t + e_next) / 2
    elif len(history) == 1:
        e_prime = (3 * e_t - history[0]) / 2
    elif len(history) == 2:
        e_prime = (23 * e_t - 16 * history[0] + 5 * history[1]) / 12
    else:
        e1, e2, e3 = history
        e_prime = (55 * e_t - 59 * e1 + 37 * e2 - 9 * e3) / 24
    return x_prev_from(e_prime, x32), (e_t, *history[:2])


def plms_sample(eps_fn: EpsFn, sched: SamplerSchedule, x_T: torch.Tensor,
                z_inpaint: torch.Tensor, mask_latent: torch.Tensor) -> torch.Tensor:
    """Full reverse PLMS chain on NHWC latents; returns x_0 (B,h,w,4)."""
    tables = plms_tables(sched, x_T.device)
    x, history = x_T, ()
    for i in torch.arange(sched.num_steps, device=x_T.device):
        x, history = plms_step(eps_fn, tables, i, x, history, z_inpaint, mask_latent)
    return x
