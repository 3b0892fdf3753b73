"""Classifier-free guidance folded into one 2B-batched UNet call (port of
``pbe_tpu/samplers/cfg.py``): eps = eps_uc + scale * (eps_c - eps_uc).
PBE's unconditional context is the learnable vector, not an empty prompt."""
from __future__ import annotations

from typing import Callable

import torch

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_cfg_eps_fn(apply_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
                    cond: torch.Tensor, uncond: torch.Tensor | None,
                    scale: float | torch.Tensor, cfg: bool | None = None) -> EpsFn:
    """eps_fn(x9, t) with CFG baked in. ``scale`` is a float or a 0-d fp32
    tensor; only guided-or-not is fixed here, as in the JAX edit program:
    ``cfg`` (by default ``scale != 1``, which a tensor scale must state)
    False or uncond None runs the UNet once at batch B. The guided
    combination is taken in fp32 from the model-dtype difference, as the
    edit pipeline's float32 scale does; a tensor scale gives a float's
    numbers bit for bit."""
    if cfg is None:
        if isinstance(scale, torch.Tensor):
            raise ValueError("a tensor scale needs cfg= (guided or not is fixed when "
                             "the function is built)")
        cfg = scale != 1.0
    if uncond is None or not cfg:
        def eps_fn(x9: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            return apply_fn(x9, t, cond)
        return eps_fn

    ctx = torch.cat([uncond.to(cond.dtype), cond], dim=0)

    def eps_fn(x9: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        e = apply_fn(torch.cat([x9, x9], dim=0), torch.cat([t, t], dim=0), ctx)
        e_uc, e_c = e.chunk(2, dim=0)
        return e_uc.float() + scale * (e_c - e_uc).float()

    return eps_fn
