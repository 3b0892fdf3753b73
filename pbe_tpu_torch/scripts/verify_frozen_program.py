"""Prove the frozen-program deployment path (port of
``scripts/verify_frozen_program.py``, its flags plus ``--device``,
``--precision`` and ``--params``).

Exports one edit (by default the v1 50-step 512^2 PLMS edit at CFG 5,
bf16), runs the live pipeline on the same inputs, then runs the frozen
programs in a subprocess that imports torch, numpy and
``pbe_tpu_torch.export_runtime`` (with the step timer of
``pbe_tpu_torch.utils.profiling``), the deployment host's footprint: it
asserts that no module of ``pbe_tpu_torch.models``, ``.pipelines`` or
``.samplers``, nor ``pbe_tpu`` or ``jax``, was imported, and that two
frozen calls are bitwise equal.

The criterion is JAX's: PASS iff max|diff| <= --tol (0.02 in the [0,1]
output, ~5 uint8 levels) against the live edit; the bitwise flag is
reported beside it. Prints one JSON line: the verdict, the differences,
the programs' and params' MB, export, save, program-load and params-load
seconds, the live edit's first call and median warm call seconds (1 +
``WARM_CALLS`` calls in this process) beside the frozen edit's (as many in
its own, each bitwise equal to the first), the step body's
runs and the frozen edit's flash launches by kernel (the first frozen
call's).

    python -m pbe_tpu_torch.scripts.verify_frozen_program --outdir /tmp/frozen_v1 \\
        [--H 512 --W 512 --steps 50] [--quantize int8]
    python -m pbe_tpu_torch.scripts.verify_frozen_program --device cpu \\
        --precision full --config configs/tiny.yaml --H 64 --W 64 --steps 4 --outdir /tmp/f
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from pbe_tpu_torch.scripts.inference import REPO, device_and_dtype

WARM_CALLS = 3  # timed calls after the first, on each side

# the deployment host: torch, numpy and the runtime loader only
_RUNNER = r"""
import json, os, sys
import numpy as np
import torch
from pbe_tpu_torch import export_runtime as rt
from pbe_tpu_torch.utils.profiling import StepTimer
banned = [m for m in sys.modules
          if m.startswith(("pbe_tpu_torch.models", "pbe_tpu_torch.pipelines",
                           "pbe_tpu_torch.samplers", "pbe_tpu.", "jax."))
          or m in ("pbe_tpu", "jax")]
if banned:
    raise SystemExit(f"model code in the serving host: {banned}")
fa = sys.modules["pbe_tpu_torch.ops.flash_attention"]

outdir, params_path = sys.argv[1], sys.argv[2]
timer = StepTimer()
timer.start()
fn = rt.load_edit_program_dir(outdir)
programs_load_s = timer.stop()
dev = fn.manifest["device"]
sync = lambda: torch.cuda.synchronize() if dev == "cuda" else None
timer.start()
params = rt.load_params_npz(params_path, device=dev)
sync()
params_load_s = timer.stop()
d = np.load(os.path.join(outdir, "inputs.npz"))
args = [d[name] for name in list(fn.in_specs)[1:]]
kernels = {"flash_fwd": fa.flash_fwd, "flash_fwd_resident": fa.flash_fwd_resident,
           "flash_fwd_pipelined": fa.flash_fwd_pipelined, "flash_bwd_dq": fa.flash_bwd_dq,
           "flash_bwd_dkv": fa.flash_bwd_dkv}
for k in kernels.values():
    k.reset()
calls = StepTimer()
calls.start()
out = fn(params, *args)
calls.stop(out)
launches = {name: k.launches for name, k in kernels.items()}
by_shape = {str(tuple(s)): n for s, n in fa.flash_fwd.launches_by_shape.items()}
for _ in range(int(sys.argv[3])):
    calls.start()
    again = fn(params, *args)
    calls.stop(again)
    if not torch.equal(out, again):
        raise SystemExit("two calls of the frozen program differ")
np.save(os.path.join(outdir, "frozen_out.npy"), out.cpu().numpy())
print(json.dumps({"programs_load_s": programs_load_s, "params_load_s": params_load_s,
                  "first_call_s": calls.times[0],
                  "warm_call_s": float(np.median(calls.times[1:])),
                  "warm_calls_s": calls.times[1:], "flash_launches": launches,
                  "flash_fwd_launches_by_shape": by_shape}))
"""


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", required=True)
    p.add_argument("--config", type=str, default="")
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--H", type=int, default=512)
    p.add_argument("--W", type=int, default=512)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=9)
    p.add_argument("--quantize", choices=["int8"], default=None)
    p.add_argument("--tol", type=float, default=0.02,
                   help="max|diff| tolerance in the [0,1] output space (~5 uint8 levels)")
    p.add_argument("--det_first_stage", type=int, default=1,
                   help="0 samples the VAE posterior: the frozen side takes the standard "
                        "normals the live generator draws after x_T")
    p.add_argument("--precision", choices=["full", "autocast"], default="autocast")
    p.add_argument("--params", type=str, default="",
                   help="an existing params.npz of the same weights (skips writing one)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv=None) -> dict:
    """Run the check; returns the JSON row. Exits non-zero on a FAIL or if
    the frozen side fails."""
    opt = get_parser().parse_args(argv)
    device, dtype = device_and_dtype(opt.device, opt.precision)

    import numpy as np
    import torch

    from pbe_tpu_torch.export_runtime import save_params_npz
    from pbe_tpu_torch.pipelines.export import export_edit_program, save_edit_program
    from pbe_tpu_torch.pipelines.loading import load_pipeline
    from pbe_tpu_torch.utils.profiling import StepTimer

    config = opt.config or os.path.join(REPO, "configs", "v1.yaml")
    pipeline, _ = load_pipeline(config, opt.ckpt or None, device=device, dtype=dtype,
                                quantize=opt.quantize, verbose=False)
    os.makedirs(opt.outdir, exist_ok=True)
    g = np.random.default_rng(opt.seed)
    b, H, W = opt.batch, opt.H, opt.W
    f, r = pipeline.model.latent_downsample, pipeline.ref_size
    image = g.uniform(-1, 1, (b, H, W, 3)).astype(np.float32)
    mask = np.ones((b, H, W, 1), np.float32)
    mask[:, H // 4: 3 * H // 4, W // 4: 3 * W // 4] = 0.0
    ref = g.standard_normal((b, r, r, 3)).astype(np.float32)
    x_T = g.standard_normal((b, H // f, W // f, 4)).astype(np.float32)
    det = bool(opt.det_first_stage)
    inputs = dict(image=image, mask=mask, ref=ref, x_T=x_T, scale=np.float32(opt.scale))
    if not det:
        # the live edit's generator draws the posterior's normals first when
        # x_T is injected
        gen = torch.Generator(device=device).manual_seed(opt.seed)
        inputs["eps_first_stage"] = torch.randn(x_T.shape, generator=gen, device=device,
                                                dtype=torch.float32).cpu().numpy()
    np.savez(os.path.join(opt.outdir, "inputs.npz"), **inputs)

    timer = StepTimer()
    timer.start()
    program = export_edit_program(pipeline, batch=b, height=H, width=W, steps=opt.steps,
                                  cfg=opt.scale != 1.0, det_first_stage=det)
    export_s = timer.stop()
    timer.start()
    manifest = save_edit_program(opt.outdir, program)
    save_s = timer.stop()
    params_path = opt.params or os.path.join(opt.outdir, "params.npz")
    if not opt.params:
        with torch.no_grad():
            save_params_npz(params_path, pipeline.model.state_dict())

    live = StepTimer()
    for _ in range(1 + WARM_CALLS):  # first and warm, as the frozen side times its calls
        live.start()
        want = pipeline.edit_batch(image, mask, ref, steps=opt.steps, scale=opt.scale,
                                   seed=opt.seed, x_T=x_T, det_first_stage=det)
        live.stop()
    del pipeline, program
    if device.startswith("cuda"):
        torch.cuda.empty_cache()

    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    run = subprocess.run([sys.executable, "-c", _RUNNER, opt.outdir, params_path,
                          str(WARM_CALLS)],
                         capture_output=True, text=True, timeout=3600, env=env)
    if run.returncode != 0:
        print(run.stdout[-3000:], file=sys.stderr)
        print(run.stderr[-3000:], file=sys.stderr)
        raise SystemExit("the model-code-free runner failed")
    frozen = json.loads(run.stdout.strip().splitlines()[-1])
    got = np.load(os.path.join(opt.outdir, "frozen_out.npy")).astype(np.float64)
    want = np.asarray(want, np.float64)
    bitwise = bool(np.array_equal(got, want))
    max_diff = float(np.abs(got - want).max())
    levels = int(np.abs(np.rint(got * 255) - np.rint(want * 255)).max())
    ok = bitwise or max_diff <= opt.tol
    mb = lambda path: os.path.getsize(path) / 1e6
    row = {
        "H": H, "W": W, "steps": opt.steps, "batch": b, "quantize": opt.quantize,
        "det_first_stage": det, "dtype": str(dtype).removeprefix("torch."),
        "pass": ok, "tol": opt.tol, "bitwise_equal_to_live": bitwise,
        "max_abs_diff": max_diff, "uint8_maxdiff_levels": levels,
        "program_mb": sum(manifest["program_bytes"].values()) / 1e6,
        "params_mb": mb(params_path), "export_s": export_s, "save_s": save_s,
        "live_first_call_s": live.times[0],
        "live_warm_call_s": float(np.median(live.times[1:])), "live_warm_calls_s": live.times[1:],
        "step_runs": manifest["programs"]["step"]["runs"], **frozen,
    }
    print(json.dumps(row))
    if not ok:
        print(f"max|diff| = {max_diff} > tol {opt.tol}", file=sys.stderr)
        raise SystemExit(1)
    return row


if __name__ == "__main__":
    main()
