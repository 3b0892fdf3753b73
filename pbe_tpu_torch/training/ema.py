"""Exponential moving average of the trainable parameters (port of
``pbe_tpu/training/ema.py``; the reference's LitEma, ldm/modules/ema.py).

One fp32 shadow per parameter; after every optimizer step the shadow moves
toward the parameter with decay ``min(0.9999, (1+n)/(10+n))``, n the
number of updates so far. Off in v1 (configs/v1.yaml:19).
"""
from __future__ import annotations

import contextlib

import torch


class EMA:
    def __init__(self, params: dict[str, torch.Tensor], max_decay: float = 0.9999):
        self.max_decay = max_decay
        self.count = 0
        self.shadow = {k: p.detach().clone() for k, p in params.items()}

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor]) -> None:
        self.count += 1
        one_minus = 1.0 - min(self.max_decay, (1.0 + self.count) / (10.0 + self.count))
        for k, s in self.shadow.items():
            s.sub_(one_minus * (s - params[k].to(s.dtype)))

    @contextlib.contextmanager
    def swapped_in(self, params: dict[str, torch.Tensor]):
        """Run the block with the shadow values in the parameters (the
        reference's ema_scope), then put the trained values back."""
        saved = {k: p.detach().clone() for k, p in params.items()}
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(self.shadow[k])
        try:
            yield
        finally:
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(saved[k])

    def state_dict(self) -> dict:
        return {"count": self.count, "shadow": self.shadow}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for k, s in self.shadow.items():
            s.copy_(state["shadow"][k])
