"""Profiling and tracing utilities (port of ``pbe_tpu/utils/profiling.py``):
a device trace over ``torch.profiler``, a step timer with percentile
summaries, and parameter and FLOP counts. FLOPs come from
``torch.utils.flop_counter``, which counts the flash-attention ops by the
formulas registered in ``ops/flash_attention.py``.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

import pbe_tpu_torch.ops.flash_attention  # noqa: F401  (the flash ops' FLOP formulas)


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Trace the host and, where there is a card, the device around a code
    region; writes a Chrome trace (``trace.json``, viewable in Perfetto or
    chrome://tracing) into ``logdir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Wall-clock step timing with a percentile summary. ``stop`` waits for
    the tensor the caller hands back (the step's output) before it reads the
    clock, so a step's time includes its device work."""

    def __init__(self) -> None:
        self.times: list[float] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync=None) -> float:
        if isinstance(sync, torch.Tensor) and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> dict[str, float]:
        t = np.asarray(self.times)
        return {
            "n": int(t.size),
            "p50_s": float(np.percentile(t, 50)),
            "p90_s": float(np.percentile(t, 90)),
            "mean_s": float(t.mean()),
        }


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return list(tree.values())
    return list(tree)


def count_params(tree) -> int:
    """Elements of a module's parameters or of a state dict's tensors."""
    return int(sum(p.numel() for p in _tensors(tree)))


def format_params(tree) -> str:
    return f"{count_params(tree) / 1e6:.1f}M params"


def compiled_flops(fn, *args, by_op: bool = False):
    """FLOPs of one call of ``fn(*args)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` as the call runs (the
    counterpart of XLA's cost analysis in the JAX package): products,
    convolutions and the flash-attention ops. ``by_op=True`` returns
    (total, {op name: FLOPs}) too."""
    with FlopCounterMode(display=False) as mode:
        fn(*args)
    total = float(mode.get_total_flops())
    if not by_op:
        return total
    counts = mode.get_flop_counts().get("Global", {})
    return total, {str(op): float(n) for op, n in counts.items()}
