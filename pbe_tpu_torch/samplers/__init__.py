"""Samplers (ports of ``pbe_tpu/samplers``). The step functions of PLMS and
DDIM read their schedule scalars from float32 tables on the latents' device,
made here once per schedule."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

_TABLES: dict[tuple, dict[str, torch.Tensor]] = {}


def schedule_tables(kind: str, sched, device: torch.device | str,
                    build: Callable[..., dict[str, np.ndarray]]) -> dict[str, torch.Tensor]:
    """``build(sched)``'s float32 tables (equal lengths) on ``device``, made
    once per sampler kind, schedule and device in one upload and reused
    after: a copy from host memory to the card waits for the card, so an
    edit makes none. The tensors are shared: read them, never write."""
    dev = torch.device(device)
    key = (kind, str(dev), float(sched.eta),
           *(np.asarray(getattr(sched, name)).tobytes()
             for name in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas",
                          "sigmas")))
    tables = _TABLES.get(key)
    if tables is None:
        host = build(sched)
        stacked = torch.from_numpy(np.stack(list(host.values()))).to(dev)
        tables = _TABLES[key] = dict(zip(host, stacked.unbind(0)))
    return tables


def divide(num: torch.Tensor, at: Callable[[str], torch.Tensor], name: str) -> torch.Tensor:
    """``num`` over the table scalar ``name`` as PyTorch divides a tensor by
    a host float: true division on the CPU, multiplication by the float32
    reciprocal (the table ``inv_<name>``) on CUDA. A division by a 0-d
    device tensor would round otherwise on the card, and the edit's numbers
    would then depend on where its scalars live."""
    return num * at(f"inv_{name}") if num.is_cuda else num / at(name)
