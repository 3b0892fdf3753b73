"""LR-multiplier schedules (port of ``pbe_tpu/training/lr_schedule.py``;
behavioural spec: the reference's ldm/lr_scheduler.py:4-97).

Each schedule is a function of the optimizer step that returns a
multiplier on the base LR, for ``torch.optim.lr_scheduler.LambdaLR``. v1
uses LambdaLinearScheduler: a 10k-step warm-up from 1e-6 to 1, then flat
(configs/v1.yaml:21-28).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class LambdaWarmUpCosineScheduler:
    """Single-cycle warm-up and cosine decay (lr_scheduler.py:4-33)."""

    warm_up_steps: int
    lr_min: float
    lr_max: float
    lr_start: float
    max_decay_steps: int
    verbosity_interval: int = 0

    def __call__(self, n: int) -> float:
        if n < self.warm_up_steps:
            return (self.lr_max - self.lr_start) / self.warm_up_steps * n + self.lr_start
        t = min((n - self.warm_up_steps) / (self.max_decay_steps - self.warm_up_steps), 1.0)
        return self.lr_min + 0.5 * (self.lr_max - self.lr_min) * (1 + math.cos(t * math.pi))


@dataclasses.dataclass
class LambdaWarmUpCosineScheduler2:
    """Multi-cycle warm-up and cosine decay (lr_scheduler.py:36-78)."""

    warm_up_steps: Sequence[int]
    f_min: Sequence[float]
    f_max: Sequence[float]
    f_start: Sequence[float]
    cycle_lengths: Sequence[int]
    verbosity_interval: int = 0

    def _per_cycle(self, n: float, c: int) -> float:
        wu, cl = self.warm_up_steps[c], self.cycle_lengths[c]
        f_min, f_max = self.f_min[c], self.f_max[c]
        if n < wu:
            return (f_max - self.f_start[c]) / wu * n + self.f_start[c]
        t = min((n - wu) / (cl - wu), 1.0)
        return f_min + 0.5 * (f_max - f_min) * (1 + math.cos(t * math.pi))

    def __call__(self, n: int) -> float:
        cum = np.cumsum([0, *self.cycle_lengths])
        # the first cycle whose end is >= n (the reference's find_in_interval)
        c = int(np.searchsorted(cum[1:], n, side="left"))
        return self._per_cycle(n - float(cum[c]), c)


@dataclasses.dataclass
class LambdaLinearScheduler(LambdaWarmUpCosineScheduler2):
    """Linear warm-up, then linear decay towards f_min over the cycle
    (lr_scheduler.py:81-97)."""

    def _per_cycle(self, n: float, c: int) -> float:
        wu, cl = self.warm_up_steps[c], self.cycle_lengths[c]
        f_min, f_max = self.f_min[c], self.f_max[c]
        if n < wu:
            return (f_max - self.f_start[c]) / wu * n + self.f_start[c]
        return f_min + (f_max - f_min) * (cl - n) / cl


def default_scheduler() -> LambdaLinearScheduler:
    """configs/v1.yaml:21-28: 10k-step warm-up 1e-6 -> 1, then flat."""
    return LambdaLinearScheduler(warm_up_steps=[10000], f_min=[1.0], f_max=[1.0],
                                 f_start=[1e-6], cycle_lengths=[10_000_000_000_000])
