"""Conditioning-key dispatch (port of ``pbe_tpu/models/diffusion_wrapper.py``,
the reference's DiffusionWrapper, ddpm.py:468-515).

The reference wraps the UNet in a module that routes conditioning by key:

  * None        : unconditional, model(x, t)
  * 'concat'    : channel-concat conditioning, model(cat([x] + c_concat), t)
  * 'crossattn' : token conditioning, model(x, t, context=cat(c_crossattn))
                  (the PBE path)
  * 'hybrid'    : both of the above
  * 'adm'       : class-label conditioning, model(x, t, y=c_crossattn[0])
                  (a UNet built with ``num_classes``: ``label_emb``)

NCHW: the channel concat is on dim 1.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

CONDITIONING_KEYS = (None, "concat", "crossattn", "hybrid", "adm")


def apply_diffusion_wrapper(model_fn: Callable, x: torch.Tensor, t: torch.Tensor,
                            conditioning_key: str | None,
                            c_concat: Sequence[torch.Tensor] | None = None,
                            c_crossattn: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
    """model_fn(x, t, context=None, y=None) -> eps; dispatch per
    ddpm.py:477-495."""
    if conditioning_key not in CONDITIONING_KEYS:
        raise NotImplementedError(f"conditioning_key={conditioning_key!r}")
    if conditioning_key is None:
        return model_fn(x, t, None)
    if conditioning_key == "concat":
        return model_fn(torch.cat([x, *c_concat], dim=1), t, None)
    if conditioning_key == "crossattn":
        return model_fn(x, t, torch.cat(list(c_crossattn), dim=1))
    if conditioning_key == "hybrid":
        return model_fn(torch.cat([x, *c_concat], dim=1), t, torch.cat(list(c_crossattn), dim=1))
    return model_fn(x, t, None, y=c_crossattn[0])
