"""The port's profiling utilities (pbe_tpu_torch/utils/profiling.py) on the
CPU: the step timer's summary (the JAX module's keys and numbers), the
parameter counts, FLOPs through torch.utils.flop_counter with the flash
ops counted, and the device trace's Chrome trace."""
import json

import numpy as np
import pytest
import torch

from pbe_tpu.utils import profiling as jprof

from pbe_tpu_torch.ops import flash_attention as tfa
from pbe_tpu_torch.utils import profiling as prof


def test_step_timer_summary_matches_the_jax_timer():
    times = [0.5, 0.1, 0.3, 0.2, 0.9]
    ours, theirs = prof.StepTimer(), jprof.StepTimer()
    ours.times, theirs.times = list(times), list(times)
    assert ours.summary() == theirs.summary()
    assert set(ours.summary()) == {"n", "p50_s", "p90_s", "mean_s"}
    assert ours.summary()["n"] == 5 and ours.summary()["p50_s"] == 0.3


def test_step_timer_times_a_step():
    timer = prof.StepTimer()
    for _ in range(3):
        timer.start()
        out = torch.ones(8) * 2
        dt = timer.stop(out)
        assert dt >= 0.0
    s = timer.summary()
    assert s["n"] == 3 and s["p50_s"] >= 0.0 and s["mean_s"] == pytest.approx(
        float(np.mean(timer.times)))


def test_count_params_of_a_module_and_a_state_dict():
    m = torch.nn.Sequential(torch.nn.Linear(10, 20), torch.nn.Linear(20, 3))
    n = 10 * 20 + 20 + 20 * 3 + 3
    assert prof.count_params(m) == prof.count_params(m.state_dict()) == n
    assert prof.format_params(m) == f"{n / 1e6:.1f}M params"


def test_compiled_flops_counts_products_and_the_flash_ops():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(16, 32, generator=g), torch.randn(32, 8, generator=g)
    assert prof.compiled_flops(torch.mm, a, b) == 2 * 16 * 32 * 8
    q, k, v = (torch.randn(1, 48, 2, 16, generator=g) for _ in range(3))
    total, by_op = prof.compiled_flops(
        lambda: tfa.flash_forward(q, k, v) @ torch.ones(1, 48, 16, 4), by_op=True)
    attn = 4 * 1 * 2 * 48 * 48 * 16
    assert by_op["pbe.flash_fwd"] == attn and total == attn + 2 * 1 * 48 * 2 * 16 * 4


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with prof.device_trace(str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("mm" in str(n) for n in names)
