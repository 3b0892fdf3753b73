"""Tile sweep of the models' forward kernel (csrc/flash_fwd.cu
``flash_fwd_kernel``) on one card.

    python -m pbe_tpu_torch.scripts.sweep_flash_tiles [--repeats 50]
        [--settings "first:48=4x64,80=4x64,160=2x32" ...]

``pbe_flash_fwd_bf16`` picks (warps, key tile) by padded head dim in its
``launch_fwd<DP, WARPS, BK>`` lines. Each setting rewrites some of those
lines (``DP=WARPSxBK``, comma-separated; ``ftz`` also takes exp2 through
``ex2.approx.ftz`` in the softmax step), and the settings are built side by
side with nvcc into ``csrc/build/sweep/`` (the shipped library is not
touched). Each is checked against ``flash_attention_plain`` (rel L2 <= 1e-2)
and timed at the edit's and the training step's UNet shapes: the kernel's
device time (torch.profiler over ``--repeats`` launches, with the LSE) and
CUDA events around the same launches made eagerly. Prints the card's name
and power limit, the build time and each setting's ptxas report, then one
JSON line per (setting, shape).
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
FTZ_EXP2 = """__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

"""


def variant_source(spec: str) -> str:
    """csrc/flash_fwd.cu with the tiles (and exp2) of one setting."""
    src = (cuda_build.CSRC / "flash_fwd.cu").read_text()
    for item in filter(None, spec.split(",")):
        if item == "ftz":
            a = src.index("template <int NT, int NO>\n__device__ __forceinline__ void softmax_step")
            b = src.index("// o += P V for one warp")
            src = src[:a] + FTZ_EXP2 + src[a:b].replace("exp2f(", "ex2_ftz(") + src[b:]
            continue
        dp, tiles = item.split("=")
        warps, bk = tiles.split("x")
        src, n = re.subn(rf"launch_fwd<{dp}, \d+, \d+>", f"launch_fwd<{dp}, {warps}, {bk}>", src)
        if n != 1:
            raise ValueError(f"no launch_fwd line for padded head dim {dp}")
    return src


def build(name: str, spec: str) -> tuple[str, str]:
    """-> (library path, ptxas lines of the models' kernels)."""
    out_dir = cuda_build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    src.write_text(variant_source(spec))
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for setting {name}:\n{proc.stderr[-4000:]}")
    lines = (proc.stdout + proc.stderr).splitlines()
    report = []
    for i, line in enumerate(lines):
        m = re.search(r"flash_fwd_(wide_kernel|kernelILi(\d+)ELi(\d+)ELi(\d+))", line)
        if "Compiling entry" in line and m:
            what = ("wide" if m[1] == "wide_kernel"
                    else f"DP {m[2]}, {m[3]} warps, key tile {m[4]}")
            report.append(f"  {what}: {lines[i + 2].strip()}; "
                          f"{lines[i + 3].split(':', 1)[1].strip()}")
    return str(lib), "\n".join(report)


def device_ms(fn, repeats: int) -> float:
    """Mean device time of the flash_fwd kernels fn launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "flash_fwd" in e.key) / 1e3 / repeats


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


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--repeats", type=int, default=50)
    p.add_argument("--settings", nargs="+", default=list(SETTINGS),
                   help="name:DP=WARPSxBK,... or name:ftz")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_flash_tiles: no CUDA device; the sweep runs on the card")
    print(card_line(), flush=True)
    settings = dict(s.split(":", 1) for s in args.settings)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(settings)) as pool:
        built = dict(zip(settings, pool.map(build, settings, settings.values())))
    print(f"built {len(built)} settings side by side in {time.perf_counter() - t0:.1f} s",
          flush=True)
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
                "device_ms": device_ms(lambda: kern(q, k, v, return_lse=True), args.repeats),
                "event_ms": event_ms(lambda: kern(q, k, v), args.repeats)}), flush=True)


if __name__ == "__main__":
    main()
