#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pbe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py    # every phase; exits 0 only if all pass

Phases:
  1. card name and power limit, torch/CUDA versions; build the flash kernel
     from csrc/flash_fwd.cu and print its -Xptxas -v report.
  2. each kernel against its plain PyTorch version at the shapes the 512^2
     edit gives it (bf16), then timed with CUDA events beside the plain
     version and the one PyTorch call that computes the same function.
  3. one full-width v1 CFG UNet call (64^2 latent, batch 2, bf16) with the
     flash kernel and with plain attention.
  4. the slice: load_pipeline("configs/v1.yaml") with random weights, a
     512^2 50-step PLMS edit at CFG scale 5 with every kernel's launch count
     set to 0 just before and read just after, then timed warm edits.
  5. device time of one warm v1 CFG UNet call by kernel (torch.profiler)
     and the device's idle share.
  6. a small edit (configs/tiny.yaml, 64^2) on the card in bf16 against the
     same edit on the CPU in fp32, the path the CPU tests hold against JAX.

Prints a {"kernels": [...]} line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when any phase fails or there is no CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# peak rates of one H100 SXM (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# special-function (exp2) throughput of H100 SXM5 as the FlashAttention-3
# paper gives it: B*H*N^2 exponentials bind before the products at d=40
EXP2_PER_S = 3.9e12

K1 = "pbe_tpu/ops/flash_attention.py:85"   # _flash_kernel_rowblock
K2 = "pbe_tpu/ops/flash_attention.py:218"  # _flash_kernel (streamed)
# (name, (B, N, H, D), TPU kernel it replaces, launches per 512^2 CFG edit):
# UNet self-attention at CFG batch 2 (8 heads) and the VAE mid attention
FLASH_SHAPES = (
    ("unet_ds1", (2, 4096, 8, 40), K1, 5 * 51),
    ("unet_ds2", (2, 1024, 8, 80), K1, 5 * 51),
    ("unet_ds4", (2, 256, 8, 160), K1, 5 * 51),
    ("unet_ds8", (2, 64, 8, 160), K1, 1 * 51),
    ("vae_mid", (1, 4096, 1, 512), K2, 2),
)
LAUNCHES_PER_EDIT = sum(s[3] for s in FLASH_SHAPES)  # 818
# bf16 tolerance of kernel vs plain, relative to the output's scale (|O| is
# ~0.02 at N=4096 with randn inputs, not ~1): both round q*scale, P and O to
# bf16 the same way, but the kernel's online softmax rounds P against a
# running max, so an element of O may land one bf16 ulp (<= 2^-7 of its
# value) away. Allowed: max|err| <= 2^-6 max|O| and rel L2 <= 1e-2; a wrong
# rescale or PV of even a few percent fails the L2 check.
OUT_MAX_REL = 2.0 ** -6
OUT_L2_REL = 1e-2
LSE_ATOL = 1e-3  # fp32 log2-domain statistics (~12), summed in another order


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from pbe_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build("flash_fwd")
    log(f"[build] flash_fwd.cu built in {time.perf_counter() - t0:.1f} s; ptxas report:\n"
        f"{cuda_build.build_log('flash_fwd').strip()}")


def check_flash(fa, q, k, v, label: str) -> tuple[float, float]:
    """Kernel against its plain version on the same inputs -> (max abs err
    of O, max abs err of the LSE); raises past the tolerances above."""
    import torch

    out, lse = fa.flash_fwd(q, k, v, return_lse=True)
    want, want_lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    diff = out.float() - want.float()
    err = diff.abs().max().item()
    scale = want.float().abs().max().item()
    rel_l2 = (diff.norm() / want.float().norm()).item()
    lerr = (lse - want_lse).abs().max().item()
    ok = err <= OUT_MAX_REL * scale and rel_l2 <= OUT_L2_REL and lerr <= LSE_ATOL
    log(f"[kernel] {label}: out max|err| {err:.3e} (max|O| {scale:.3e}, tol "
        f"{OUT_MAX_REL * scale:.3e}), rel L2 {rel_l2:.3e} (tol {OUT_L2_REL}), "
        f"rms O {want.float().square().mean().sqrt().item():.3e}; lse max|err| "
        f"{lerr:.3e} (tol {LSE_ATOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash kernel disagrees with its plain version at {label}")
    del out, lse, want, want_lse, diff
    torch.cuda.synchronize()
    return err, lerr


def phase_kernels() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from pbe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    # masking and padding beyond the main-path shapes: ragged N, other dims
    for shape in ((1, 100, 2, 40), (2, 333, 3, 80), (1, 77, 1, 512), (2, 130, 4, 8)):
        check_flash(fa, rand(shape), rand(shape), rand(shape), f"check {shape}")

    rows = []
    for name, shape, replaces, _ in FLASH_SHAPES:
        b, n, h, d = shape
        q, k, v = rand(shape), rand(shape), rand(shape)
        err, lerr = check_flash(fa, q, k, v, f"{name} {shape}")
        # the least time for this work: products at the bf16 tensor-core
        # rate, exponentials at the special-function rate (both operations),
        # or q, k, v read once and o written once at the HBM rate
        t_mma = 4.0 * b * h * n * n * d / BF16_FLOP_PER_S * 1e3
        t_exp2 = 1.0 * b * h * n * n / EXP2_PER_S * 1e3
        t_bytes = 4.0 * b * n * h * d * 2 / HBM_BYTES_PER_S * 1e3
        binding = max(("mma", t_mma), ("exp2", t_exp2), ("bytes", t_bytes),
                      key=lambda x: x[1])
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row = {"name": f"flash_fwd/{name}", "route": "cuda",
               "source": "pbe_tpu_torch/csrc/flash_fwd.cu", "replaces": replaces,
               "launches": None, "max_abs_err": err, "lse_max_abs_err": lerr,
               "ms": cuda_ms(lambda: fa.flash_fwd(q, k, v), 20),
               "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 5, 1),
               "bound_ms": binding[1],
               "bound_by": "bytes" if binding[0] == "bytes" else "operations",
               "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)}
        log(f"[kernel] {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
            f"ms, sdpa {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms by "
            f"{binding[0]} (mma {t_mma:.4f}, exp2 {t_exp2:.4f}, bytes {t_bytes:.4f})")
        rows.append(row)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def set_attn_impl(model, impl: str) -> None:
    for m in model.modules():
        if hasattr(m, "attn_impl"):
            m.attn_impl = impl


def phase_unet(model) -> None:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    x9 = torch.randn((2, 64, 64, 9), generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((2, 1, 768), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.tensor([500.0, 500.0], device="cuda")
    with torch.inference_mode():
        eps_flash = model.apply_model(x9, t, ctx).float()
        set_attn_impl(model, "plain")
        eps_plain = model.apply_model(x9, t, ctx).float()
        set_attn_impl(model, "flash")
    rel = ((eps_flash - eps_plain).norm() / eps_plain.norm()).item()
    finite = bool(torch.isfinite(eps_flash).all())
    # bf16 through 16 transformer blocks and 25 res blocks: the attention
    # outputs differ by bf16 rounding (2^-8), which the residual stream
    # carries; a wrong kernel gives O(1)
    log(f"[unet] v1 CFG call (2,64,64,9) bf16: flash vs plain eps rel L2 {rel:.3e} "
        f"(tol 5e-2), eps rms {eps_plain.square().mean().sqrt().item():.4f}")
    if not (finite and rel <= 5e-2):
        raise AssertionError("full UNet with the flash kernel disagrees with plain attention")


def phase_profile(model) -> None:
    """Where one warm v1 CFG UNet call spends the card's time: device time
    by kernel (torch.profiler) and the device's idle share, taken against
    the call's wall time without the profiler (which slows the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(7)
    x9 = torch.randn((2, 64, 64, 9), generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((2, 1, 768), generator=gen, device="cuda").to(torch.bfloat16)
    t = torch.tensor([500.0, 500.0], device="cuda")
    calls = 5
    with torch.inference_mode():
        for _ in range(2):
            model.apply_model(x9, t, ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            model.apply_model(x9, t, ctx)
        torch.cuda.synchronize()
        plain_wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                model.apply_model(x9, t, ctx)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    # device-side entries only: the CPU ops' entries repeat their kernels' time
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and dev_ms(e) > 0),
                     key=dev_ms, reverse=True)
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    busy = sum(dev_ms(e) for e in kernels)
    groups: dict[str, float] = {}
    for e in kernels:
        n = e.key.lower()
        g = ("flash_fwd" if "flash_fwd" in n else
             "layout (nchw<->nhwc)" if "nchwtonhwc" in n or "nhwctonchw" in n else
             "conv" if any(s in n for s in ("conv", "fprop", "implicit", "dgrad")) else
             "gemm" if any(s in n for s in ("gemm", "nvjet", "cublas", "cutlass")) else
             "norm" if "norm" in n or "moments" in n else
             "copy/cast" if "copy" in n else "elementwise/other")
        groups[g] = groups.get(g, 0.0) + dev_ms(e)
    log(f"[profile] v1 CFG UNet call x{calls}: wall {plain_wall_ms / calls:.3f} ms/call "
        f"({wall_ms / calls:.3f} under the profiler), device busy {busy / calls:.3f} "
        f"ms/call, idle share {1 - busy / plain_wall_ms:.3f}")
    log(f"[profile] by group (ms/call): "
        f"{json.dumps({k: round(v / calls, 4) for k, v in sorted(groups.items())})}")
    for e in kernels[:15]:
        log(f"[profile]   {dev_ms(e) / calls:9.4f} ms/call  x{e.count // calls:4d}  "
            f"{e.key[:110]}")


def edit_inputs(size: int, ref_size: int, seed: int):
    g = np.random.default_rng(seed)
    image = g.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    mask = np.ones((1, size, size, 1), np.float32)
    q = size // 4
    mask[:, q:3 * q, q:3 * q] = 0.0
    ref = g.standard_normal((1, ref_size, ref_size, 3)).astype(np.float32)
    return image, mask, ref


def phase_edit(pipe, card: str, rows: list[dict]) -> dict:
    import torch

    from pbe_tpu_torch.ops import flash_attention as fa

    image, mask, ref = edit_inputs(512, 224, seed=2)
    fa.flash_fwd.launches = 0
    fa.flash_fwd.launches_by_shape.clear()
    t0 = time.perf_counter()
    out = pipe.edit_batch(image, mask, ref, steps=50, scale=5.0, seed=3)
    first_s = time.perf_counter() - t0
    launches = fa.flash_fwd.launches
    by_shape = dict(fa.flash_fwd.launches_by_shape)
    log(f"[edit] 512^2 50-step PLMS scale 5 batch 1: first edit {first_s:.3f} s, "
        f"flash launches {launches} (expected {LAUNCHES_PER_EDIT}), by shape {by_shape}")
    if out.shape != (1, 512, 512, 3) or not np.isfinite(out).all():
        raise AssertionError(f"edit output shape {out.shape} or non-finite values")
    if out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"edit output outside [0,1]: [{out.min()}, {out.max()}]")
    log(f"[edit] output mean {out.mean():.4f} std {out.std():.4f}")
    if launches != LAUNCHES_PER_EDIT:
        raise AssertionError(f"flash kernel launched {launches} times, not "
                             f"{LAUNCHES_PER_EDIT}")
    for row, (_, shape, _, per_edit) in zip(rows, FLASH_SHAPES):
        row["launches"] = by_shape.get(shape, 0)
        if row["launches"] != per_edit:
            raise AssertionError(f"{row['name']}: {row['launches']} launches, expected "
                                 f"{per_edit}")
    times = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.edit_batch(image, mask, ref, steps=50, scale=5.0, seed=4 + i)
        times.append(time.perf_counter() - t0)
    p50 = float(np.median(times))
    log(f"[edit] warm edits {['%.4f' % t for t in times]} s: p50 {p50:.4f} s, "
        f"{1.0 / p50:.4f} edits/s ({card})")
    return {"first_edit_s": first_s, "warm_edit_s": times, "p50_s": p50,
            "edits_per_s": 1.0 / p50}


def phase_reference() -> None:
    """configs/tiny.yaml 64^2 edit: bf16 + flash kernel on the card against
    fp32 + plain attention on the CPU, the same seeded weights."""
    import torch

    from pbe_tpu_torch.pipelines.loading import load_pipeline, randomize_zero_params

    gpu, _ = load_pipeline("configs/tiny.yaml", device="cuda", verbose=False)
    randomize_zero_params(gpu.model, seed=0)
    cpu, _ = load_pipeline("configs/tiny.yaml", device="cpu", dtype=torch.float32,
                           attn_impl="plain", verbose=False)
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    image, mask, ref = edit_inputs(64, gpu.ref_size, seed=5)
    n = 64 // gpu.model.latent_downsample
    x_T = np.random.default_rng(6).standard_normal((1, n, n, 4)).astype(np.float32)
    kw = dict(steps=4, scale=5.0, x_T=x_T, det_first_stage=True)
    got = gpu.edit_batch(image, mask, ref, **kw)
    want = cpu.edit_batch(image, mask, ref, **kw)
    diff = np.abs(got - want)
    # bf16 activations and weights (rel 2^-8) through 5 UNet calls and the
    # VAE decode, against fp32: a few bf16 ulps of the [0,1] image on average
    log(f"[reference] tiny 64^2 4-step edit, card bf16 vs CPU fp32: max|diff| "
        f"{diff.max():.4f} (tol 0.15), mean {diff.mean():.5f} (tol 0.02)")
    if not (np.isfinite(got).all() and diff.max() <= 0.15 and diff.mean() <= 0.02):
        raise AssertionError("card edit disagrees with the CPU fp32 reference")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    try:
        import pbe_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the pbe_tpu_torch package is not next to this script ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"[env] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase_build()
    rows = phase_kernels()
    from pbe_tpu_torch.pipelines.loading import (eps_rms_probe, load_pipeline,
                                                 randomize_zero_params)

    t0 = time.perf_counter()
    pipe, _ = load_pipeline("configs/v1.yaml", device="cuda")
    randomize_zero_params(pipe.model, seed=0)
    torch.cuda.synchronize()
    log(f"[load] v1 built and initialized on the card in {time.perf_counter() - t0:.1f} s")
    rms = eps_rms_probe(pipe.model)
    log(f"[load] eps rms probe {rms:.4f} (must exceed 1e-3)")
    if not rms > 1e-3:
        raise AssertionError("eps is ~0: the zero-init heads were not randomized")
    phase_unet(pipe.model)
    edit = phase_edit(pipe, card, rows)
    phase_profile(pipe.model)  # after the timed edits: the profiler slows the host
    del pipe
    torch.cuda.empty_cache()
    phase_reference()
    log(f"[edit] summary {json.dumps(edit)}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
