"""Split the training CLI's step time on the card: the trainer alone
(``chip_smoke.py`` phase 9), the two AdamWs alone on v1's trainable
weights, then the CLI (phase 15) as ``chip_smoke.py`` runs it and in
variants — fp32 moments (torch's AdamW), a metric log every 8 steps
instead of every step, 2 loader threads instead of 8 — and once more as
it runs it, for the spread between identical runs.

    PYTHONPATH=. python -m pbe_tpu_torch.scripts.diag_train_cli   # from a checkout, on the card

Each line names the card and its power limit. A variant fails some of
phase 15's checks by design (its moments are fp32, or its log has one
row); the failure is printed and the next variant runs. Needs
``chip_smoke.py`` at the checkout's root and one CUDA device.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch


def time_optimizers(params: dict, card: str, log) -> None:
    """optimizer.step() of torch's foreach AdamW and of the port's bf16-moment
    AdamW, in turns, on the same weights and gradients: host time to enqueue,
    wall time to a synchronized end, and the step's transient memory."""
    from pbe_tpu_torch.training.train_step import make_optimizer

    gen = torch.Generator(device="cuda").manual_seed(0)
    for p in params.values():
        p.grad = torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
    for name, mu in (("torch AdamW (foreach)", None), ("port AdamW, bf16 mu", torch.bfloat16)) * 2:
        opt, _ = make_optimizer(params, base_lr=1e-9, mu_dtype=mu)
        for _ in range(3):
            opt.step()
        torch.cuda.synchronize()
        host, wall = [], []
        for _ in range(10):
            t = time.perf_counter()
            opt.step()
            host.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t) * 1e3)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        opt.step()
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - base) / 2**30
        log(f"[diag] {name}: host enqueue ms p50 {np.median(host):.2f}, synced wall ms p50 "
            f"{np.median(wall):.2f}, transient peak {extra:.3f} GiB ({card})")
        del opt
        torch.cuda.empty_cache()
    for p in params.values():
        p.grad = None


def main() -> int:
    if not torch.cuda.is_available():
        print("diag_train_cli: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    import chip_smoke as c
    from pbe_tpu_torch.scripts.bench_attention import card_line
    from pbe_tpu_torch.training.partition import split_parameters

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    c.log(f"[env] {card}; torch {torch.__version__}")
    c.phase_build()
    model = c.build_v1_for_training()
    p9 = c.phase_train(model, card, [])
    params, _ = split_parameters(model)
    time_optimizers(params, card, c.log)
    del model, params
    torch.cuda.empty_cache()
    args = c.CLI_TRAIN_ARGS
    variants = (
        ("A as chip_smoke runs it", args, 8),
        ("B fp32 moments (torch's AdamW)", tuple(a for a in args if a != "--bf16_moments"), 8),
        ("C a metric log every 8 steps", tuple("8" if a == "1" and args[i - 1] == "--log_every"
                                             else a for i, a in enumerate(args)), 8),
        ("D 2 loader threads", args, 2),
        ("A again", args, 8),
    )
    for label, cli_args, workers in variants:
        c.log(f"[diag] ===== {label}")
        try:
            c.phase_train_cli(card, p9, cli_args, workers)
        except AssertionError as e:
            c.log(f"[diag] (this variant fails a check by design) {e}")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
