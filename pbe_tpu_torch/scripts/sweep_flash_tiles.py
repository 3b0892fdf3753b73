"""Tile sweep of the flash kernels on one card: the models' forward
(csrc/flash_fwd.cu ``flash_fwd_kernel``), with ``--bwd`` the backward
(csrc/flash_bwd.cu ``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel``),
with ``--variants`` the resident and pipelined kernels
(csrc/flash_variants.cu).

    python -m pbe_tpu_torch.scripts.sweep_flash_tiles [--bwd | --variants]
        [--repeats 50] [--settings "first:48=4x64,80=4x64,160=2x32" ...]

``pbe_flash_fwd_bf16`` picks (warps, key tile) by padded head dim in its
``launch_fwd<DP, WARPS, BK>`` lines. Each setting rewrites some of those
lines (``DP=WARPSxBK``, comma-separated; ``ftz`` also takes exp2 through
``ex2.approx.ftz`` in the softmax step). With ``--bwd`` a setting rewrites
the backward's lines instead: ``dqDP=WARPSxBKxHOLDxMINB`` for
``launch_dq<DP, WARPS, BK, HOLD, MINB>`` and
``dkvDP=WARPSxBQxHOLDxSPLITxMINB`` for ``launch_dkv<DP, WARPS, BQ, HOLD,
SPLIT, MINB>`` (HOLD 1 or 0). With ``--variants`` a setting rewrites the
constants of flash_variants.cu: ``stages=N`` and ``rwarps=N``
(``kResidentStages``, ``kResidentWarps``: the resident kernel's ring stages
and consumer warps at d <= 160) and ``warps16=DP``
(``kPipelined16WarpsDP``: the largest padded head dim at which the
pipelined kernel runs 16 warps a block), and each
setting's kernels are timed by CUDA graph at the attention benchmark's
shapes (the pipelined kernel at every key chunk, the resident one at its
default key block and every cluster size). The settings are
built side by side with nvcc into ``csrc/build/sweep/`` (the shipped
library is not touched). Each is checked against its plain version (rel
L2 <= 1e-2 for every output) and timed at the UNet shapes of the edit and
the training step (forward) or of the training step (backward): the
kernel's device time (torch.profiler over ``--repeats`` launches, the
forward with the LSE) and CUDA events around the same launches made
eagerly. Prints the card's name and power limit, the build time and each
setting's ptxas report (registers and spill bytes of every
instantiation), then one JSON line per (setting, shape[, kernel]).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from pbe_tpu_torch.ops import cuda_build
from pbe_tpu_torch.ops import flash_attention as fa
from pbe_tpu_torch.scripts.bench_attention import card_line

# the shipped tiles first, then the ones they were chosen over
SETTINGS = (
    "shipped:",
    "first:48=4x64,80=4x64,160=2x32",
    "bk128:48=4x128,80=4x128,160=4x32",
    "w8:48=8x64,80=8x64,160=1x32",
    "w8bk128:48=8x128,80=2x64,160=2x64",
    "ftz:ftz",
)
SHAPES = {
    "unet_ds1": (2, 4096, 8, 40), "unet_ds2": (2, 1024, 8, 80),
    "unet_ds4": (2, 256, 8, 160), "unet_ds8": (2, 64, 8, 160),
    "unet_ds1_train": (4, 4096, 8, 40), "unet_ds4_train": (4, 256, 8, 160),
}
# the backward's settings, the shipped tiles first
BWD_SETTINGS = (
    "shipped:",
    "first:dq48=8x64x1x1,dq80=4x64x1x1,dq160=4x32x0x1,dkv48=8x64x1x1x1,dkv80=4x32x1x1x1",
    "w8x2:dq48=8x32x1x2,dkv48=8x32x0x1x2,dkv80=8x32x1x1x1,dq160=4x32x0x1",
    "t64:dq48=16x64x1x1,dkv48=8x64x0x1x2,dq80=4x64x1x1,dkv160=4x64x0x2x1",
    "m4:dq48=4x32x1x4,dkv48=4x32x0x1x4,dkv80=8x32x0x2x2,dkv160=4x32x0x2x2",
    "t16:dkv48=16x16x1x1x1,dkv80=8x16x1x1x1,dkv160=4x16x0x2x1",
)
BWD_SHAPES = {
    "unet_ds1_train": (4, 4096, 8, 40), "unet_ds2_train": (4, 1024, 8, 80),
    "unet_ds4_train": (4, 256, 8, 160), "unet_ds8_train": (4, 64, 8, 160),
}
# the resident and pipelined kernels' settings, the shipped constants first
VARIANT_SETTINGS = (
    "shipped:",
    "first:stages=2,warps16=0",
    "st4:stages=4",
    "rw8:rwarps=8",
    "rw8st4:rwarps=8,stages=4",
)
VARIANT_CONSTANTS = {"stages": "kResidentStages", "rwarps": "kResidentWarps",
                     "warps16": "kPipelined16WarpsDP"}
# template arguments after the head dim of each backward launch line
BWD_ARGS = {"dq": ("warps", "bk", "hold", "minb"),
            "dkv": ("warps", "bq", "hold", "split", "minb")}
# put before csrc/mma_sm90.cuh is included: its softmax step takes this exp2
FTZ_EXP2 = """__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
#define PBE_SOFTMAX_EXP2 ex2_ftz

"""


def variant_source(spec: str, source: str = "flash_fwd") -> str:
    """csrc/<source>.cu with the tiles (and exp2) of one setting."""
    src = (cuda_build.CSRC / f"{source}.cu").read_text()
    for item in filter(None, spec.split(",")):
        if source == "flash_variants":
            key, val = item.split("=")
            src, n = re.subn(rf"constexpr int {VARIANT_CONSTANTS[key]} = \d+;",
                             f"constexpr int {VARIANT_CONSTANTS[key]} = {int(val)};", src)
            if n != 1:
                raise ValueError(f"no constant {VARIANT_CONSTANTS[key]} in {source}.cu")
            continue
        if item == "ftz":
            src = src.replace('#include "mma_sm90.cuh"', FTZ_EXP2 + '#include "mma_sm90.cuh"')
            continue
        key, tiles = item.split("=")
        m = re.fullmatch(r"(dq|dkv)?(\d+)", key)
        if m is None or (m[1] is None) != (source == "flash_fwd"):
            raise ValueError(f"setting item {item!r} names no launch line of {source}.cu")
        kern, dp, args = m[1] or "fwd", m[2], tiles.split("x")
        if kern != "fwd":
            if len(args) != len(BWD_ARGS[kern]):
                raise ValueError(f"{item!r}: launch_{kern} takes {', '.join(BWD_ARGS[kern])}")
            args[2] = {"1": "true", "0": "false"}[args[2]]
        src, n = re.subn(rf"launch_{kern}<{dp}, [^>]+>", f"launch_{kern}<{dp}, {', '.join(args)}>",
                         src)
        if n != 1:
            raise ValueError(f"no launch_{kern} line for padded head dim {dp}")
    return src


def ptxas_report(log: str) -> str:
    """One line per instantiation of the flash kernels (forward, its
    resident and pipelined variants, backward) in a -Xptxas -v log: its
    template arguments, registers and spill bytes."""
    lines = log.splitlines()
    report = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '_Z\w*?"
                      r"(flash_(?:fwd|fwd_wide|resident|resident_wide|pipelined|pipelined_wide"
                      r"|bwd_dq|bwd_dkv)_kernel)(I\w+?EE)?", line)
        if m and i + 3 < len(lines):
            args = ", ".join(re.findall(r"L[ib](\d+)E", m[2] or "")) or "-"
            report.append(f"  {m[1]}<{args}>: {lines[i + 2].strip()}; "
                          f"{lines[i + 3].split(':', 1)[1].strip()}")
    return "\n".join(report)


def build(name: str, spec: str, source: str = "flash_fwd") -> tuple[str, str]:
    """-> (library path, ptxas lines of the kernels)."""
    out_dir = cuda_build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / f"{source}_{name}.cu", out_dir / f"lib{source}_{name}.so"
    src.write_text(variant_source(spec, source))
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                           str(cuda_build.CSRC), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for setting {name}:\n{proc.stderr[-4000:]}")
    return str(lib), ptxas_report(proc.stdout + proc.stderr)


def device_ms(fn, repeats: int, kernel: str = "flash_fwd") -> float:
    """Mean device time of the kernels named `kernel` that fn launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and kernel in e.key) / 1e3 / repeats


def event_ms(fn, repeats: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def sweep_forward(built: dict, settings: dict, repeats: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {name: [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3)] for name, shape in SHAPES.items()}
    kern = fa.FlashForward()
    for name, (lib, report) in built.items():
        print(f"[{name}] {settings[name] or 'as shipped'}\n{report}", flush=True)
        fn = ctypes.CDLL(lib).pbe_flash_fwd_bf16
        fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
        kern._fn = fn
        for sname, (q, k, v) in data.items():
            got = kern(q, k, v).float()
            want = fa.flash_attention_plain(q, k, v).float()
            rel_l2 = ((got - want).norm() / want.norm()).item()
            if rel_l2 > 1e-2:
                raise AssertionError(f"setting {name} disagrees with the plain version at "
                                     f"{sname}: rel L2 {rel_l2:.3e}")
            print(json.dumps({
                "setting": name, "shape": sname, "rel_l2": rel_l2,
                "device_ms": device_ms(lambda: kern(q, k, v, return_lse=True), repeats),
                "event_ms": event_ms(lambda: kern(q, k, v), repeats)}), flush=True)


def sweep_backward(built: dict, settings: dict, repeats: int) -> None:
    """Each setting's dQ and dK/dV kernels at the training shapes, on
    inputs whose O and LSE come from the shipped forward kernel."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for sname, shape in BWD_SHAPES.items():
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        out, lse = fa.flash_fwd(q, k, v, return_lse=True)
        data[sname] = (q, k, v, do, lse, fa.rowsum_do_o(do, out))
    plain = {"dq": fa.flash_bwd_dq_plain, "dkv": fa.flash_bwd_dkv_plain}
    kerns = {which: fa.FlashBackward(which) for which in plain}
    for name, (lib, report) in built.items():
        print(f"[{name}] {settings[name] or 'as shipped'}\n{report}", flush=True)
        for which, kern in kerns.items():
            fn = getattr(ctypes.CDLL(lib), kern.symbol)
            fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
            kern._fn = fn
        for sname, args in data.items():
            for which, kern in kerns.items():
                got, want = kern(*args), plain[which](*args)
                if which == "dq":
                    got, want = (got,), (want,)
                rel_l2 = max(((g.float() - w.float()).norm() / w.float().norm()).item()
                             for g, w in zip(got, want))
                if rel_l2 > 1e-2:
                    raise AssertionError(f"setting {name} {which} disagrees with the plain "
                                         f"version at {sname}: rel L2 {rel_l2:.3e}")
                print(json.dumps({
                    "setting": name, "shape": sname, "kernel": which, "rel_l2": rel_l2,
                    "device_ms": device_ms(lambda: kern(*args), repeats, f"flash_bwd_{which}_"),
                    "event_ms": event_ms(lambda: kern(*args), repeats)}), flush=True)


def sweep_variants(built: dict, settings: dict, repeats: int) -> None:
    """Each setting's resident and pipelined kernels at the attention
    benchmark's shapes, checked against the plain version and timed by
    CUDA graph."""
    from pbe_tpu_torch.scripts.bench_attention import SHAPES, time_us

    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {name: [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3)] for name, shape in SHAPES.items()}
    kerns = {v: fa.FlashForward(v) for v in ("resident", "pipelined")}
    for name, (lib, report) in built.items():
        print(f"[{name}] {settings[name] or 'as shipped'}\n{report}", flush=True)
        for kern in kerns.values():
            fn = getattr(ctypes.CDLL(lib), kern.symbol)
            fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
            kern._fn = fn
        for sname, (q, k, v) in data.items():
            want = fa.flash_attention_plain(q, k, v).float()
            dp = fa._round_up(q.shape[3], 16)
            launches = ([("pipelined", {"block": b}) for b in fa.PIPELINED_BLOCKS[dp]]
                        + [("resident", {"cluster": c}) for c in fa.CLUSTER_SIZES])
            for variant, kw in launches:
                got = kerns[variant](q, k, v, **kw).float()
                rel_l2 = ((got - want).norm() / want.norm()).item()
                if rel_l2 > 1e-2:
                    raise AssertionError(f"setting {name} {variant} {kw} disagrees with the "
                                         f"plain version at {sname}: rel L2 {rel_l2:.3e}")
                print(json.dumps({
                    "setting": name, "shape": sname, "kernel": variant, **kw, "rel_l2": rel_l2,
                    "graph_ms": time_us(lambda: kerns[variant](q, k, v, **kw), repeats,
                                        q.device) / 1e3}), flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    which = p.add_mutually_exclusive_group()
    which.add_argument("--bwd", action="store_true",
                       help="sweep the backward kernels (csrc/flash_bwd.cu)")
    which.add_argument("--variants", action="store_true",
                       help="sweep the resident and pipelined kernels (csrc/flash_variants.cu)")
    p.add_argument("--repeats", type=int, default=50)
    p.add_argument("--settings", nargs="+", default=None,
                   help="name:DP=WARPSxBK,... or name:ftz (forward); "
                        "name:dqDP=WARPSxBKxHOLDxMINB,dkvDP=WARPSxBQxHOLDxSPLITxMINB,... (--bwd)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_flash_tiles: no CUDA device; the sweep runs on the card")
    print(card_line(), flush=True)
    source = "flash_bwd" if args.bwd else "flash_variants" if args.variants else "flash_fwd"
    settings = dict(s.split(":", 1) for s in args.settings or {
        "flash_fwd": SETTINGS, "flash_bwd": BWD_SETTINGS,
        "flash_variants": VARIANT_SETTINGS}[source])
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(settings)) as pool:
        built = dict(zip(settings, pool.map(build, settings, settings.values(),
                                            [source] * len(settings))))
    print(f"built {len(built)} settings of {source}.cu side by side in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    {"flash_fwd": sweep_forward, "flash_bwd": sweep_backward,
     "flash_variants": sweep_variants}[source](built, settings, args.repeats)


if __name__ == "__main__":
    main()
