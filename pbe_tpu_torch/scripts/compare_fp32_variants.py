"""Time csrc/flash_fp32.cu's resident (K3) and pipelined (K4) kernels of
this checkout and of another side by side on one card: K3 at every fp32
key block and cluster size, K4 at every key block and the fp32 forward,
at the attention benchmark's shapes.

    python -m pbe_tpu_torch.scripts.compare_fp32_variants OTHER   # from a checkout, on the card

Builds flash_fp32.cu in both checkouts at once, prints the card's name
and power limit and each build's K3/K4 ptxas lines, then runs each
checkout's chip_smoke.py phase 11 fp32 part (every check) and timings in
a child process from its own root, in the order other, this, this,
other: one "[time]" JSON line a shape and run. Full logs go under
chiprun_out/. Needs chip_smoke.py at both roots and one CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

THIS = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD = ("import time; t = time.perf_counter(); from pbe_tpu_torch.ops import cuda_build as b; "
         "b.build('flash_fp32'); print(f'built in {time.perf_counter() - t:.1f} s'); "
         "from pbe_tpu_torch.scripts.sweep_flash_tiles import ptxas_report; "
         "print(ptxas_report(b.build_log('flash_fp32')))")


def child() -> None:
    """In a checkout's root: phase 11's fp32 part, then the timings."""
    import torch

    import chip_smoke as c
    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.scripts import bench_attention as bench

    c.phase_variants_f32()
    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, shape in bench.SHAPES.items():
        dp = (shape[3] + 15) // 16 * 16
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        row = {"name": name, "fwd": c.graph_ms(lambda: fa.flash_fwd(q, k, v), 20)}
        for blk in fa.block_table("resident", f32)[dp]:
            for cl in fa.CLUSTER_SIZES:
                row[f"K3 b{blk} c{cl}"] = c.graph_ms(
                    lambda: fa.flash_fwd_resident(q, k, v, block=blk, cluster=cl), 20)
        for blk in fa.block_table("pipelined", f32)[dp]:
            row[f"K4 b{blk}"] = c.graph_ms(lambda: fa.flash_fwd_pipelined(q, k, v, block=blk),
                                           20)
        print("[time]", json.dumps({key: round(x, 4) if isinstance(x, float) else x
                                    for key, x in row.items()}), flush=True)


def main(argv: list[str]) -> int:
    trees = {"other": os.path.abspath(argv[0]), "this": THIS}
    out = os.path.join(THIS, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    env = {key: dict(os.environ, PYTHONPATH=root) for key, root in trees.items()}
    builds = {key: subprocess.Popen([sys.executable, "-c", BUILD], cwd=root, env=env[key],
                                    text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
              for key, root in trees.items()}
    for key, proc in builds.items():
        log = proc.communicate()[0]
        with open(os.path.join(out, f"compare_build_{key}.log"), "w") as f:
            f.write(log)
        print(f"== {key}:", log.splitlines()[0] if proc.returncode == 0 else log[-3000:],
              flush=True)
        if proc.returncode:
            return 1
        for line in log.splitlines():
            if "resident_f32" in line or "pipelined_f32" in line:
                print("  ", line.strip(), flush=True)
    failed = 0
    for i, key in enumerate(("other", "this", "this", "other")):
        t = time.perf_counter()
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child"],
                             cwd=trees[key], env=env[key], text=True, capture_output=True)
        with open(os.path.join(out, f"compare_run_{i}_{key}.log"), "w") as f:
            f.write(run.stdout + run.stderr)
        print(f"== run {i} {key}: rc {run.returncode} in {time.perf_counter() - t:.1f} s",
              flush=True)
        for line in run.stdout.splitlines():
            if line.startswith("[time]"):
                print(line, flush=True)
        if run.returncode:
            print(run.stderr[-3000:], flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
    else:
        sys.exit(main(sys.argv[1:]))
