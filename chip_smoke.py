#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pbe_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py    # every phase; exits 0 only if all pass

Phases:
  1. card name and power limit, torch/CUDA versions; build the kernels
     from csrc/flash_fwd.cu (the models' forward kernels), flash_variants.cu
     (the resident and pipelined kernels) and flash_bwd.cu (one nvcc each,
     started together) and print each kernel's registers and spills from
     their -Xptxas -v reports.
  2. each kernel against its plain PyTorch version at the shapes the 512^2
     edit gives it (bf16), at ragged N for every padded head dim, and with
     peaked scores, a row max rising at every key tile and packed q/k/v
     views at the edit's head dims; then timed beside the plain version and
     the one PyTorch call that computes the same function (CUDA events
     around a CUDA graph of 20 calls, and the kernel's eager launches too).
  3. one full-width v1 CFG UNet call (64^2 latent, batch 2, bf16) with the
     flash kernel and with plain attention.
  4. the slice: load_pipeline("configs/v1.yaml") with random weights, a
     512^2 50-step PLMS edit at CFG scale 5 with every kernel's launch count
     set to 0 just before and read just after, then timed warm edits, and
     one edit with block=False polled with is_ready() and read back
     against the same edit with block=True.
  5. device time of one warm v1 CFG UNet call by kernel (torch.profiler)
     and the device's idle share.
  6. a small edit (configs/tiny.yaml, 64^2) on the card in bf16 against the
     same edit on the CPU in fp32, the path the CPU tests hold against JAX.
Training (the second slice):
  7. the backward kernels (csrc/flash_bwd.cu) against their plain versions
     at the v1 training shapes (batch 4), with peaked scores and packed
     q/k/v views there, and at ragged N for every padded head dim, each
     launched twice and compared bitwise; then timed beside the plain
     versions and SDPA's backward alone (all around CUDA graphs); the
     forward kernel with the LSE timed at the same shapes.
  8. one v1 UNet loss at batch 4 (bf16, remat) backpropagated through the
     flash kernels and through plain attention: the gradients compared.
  9. the slice: Trainer.fit on v1 at full width, batch 4, 512^2, with the
     launch counts per step checked, loss, grad_norm, frozen weights and
     AdamW state checked, step p50, images/s, peak memory and one step's
     device time by group (torch.profiler).
 10. 3 training steps of configs/tiny.yaml on the card in bf16 against the
     same steps on the CPU in fp32 (the path the CPU tests hold against
     JAX).

The attention benchmark (the third slice, its kernels redesigned in the
sixth):
 11. the resident and pipelined kernels (csrc/flash_variants.cu) against
     the plain version at ragged and odd shapes, at every key block they
     instantiate and every cluster size of the resident kernel; at the
     benchmark's shapes (the VAE's included) every
     flash_forward(variant=...) call against the plain version and counted
     as one launch of its kernel, both kernels on inputs whose row max
     rises at every key tile, and at every key block and cluster size;
     each timed (a CUDA graph of 20 calls) beside the plain version and
     SDPA, the resident kernel at clusters of 1, 2 and 4; then the bench
     entry (pbe_tpu_torch.scripts.bench_attention) over every shape and
     impl, with every kernel's launch count set to 0 just before and read
     just after.

A run takes them in the order 1, 2, 7, 11, 3-5, 8, 9, 6, 10: kernels first,
the card-vs-CPU comparisons last.

Prints a {"kernels": [...]} line, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when any phase fails or there is no CUDA device.
"""
from __future__ import annotations

import json
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
K3 = "pbe_tpu/ops/flash_attention.py:182"  # _flash_kernel_resident
K4 = "pbe_tpu/ops/flash_attention.py:111"  # _flash_kernel_pipelined
K5 = "pbe_tpu/ops/flash_attention.py:408"  # _flash_bwd_dq_kernel
K6 = "pbe_tpu/ops/flash_attention.py:445"  # _flash_bwd_dkv_kernel
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
# N that no q tile (256 rows at d=40, 128 at 80, 64 at 8-32 and 160, 32 at
# 512) or key tile (128, 64 or 32) of flash_fwd divides, at every padded
# head dim: 48, 80, 512, 16 (d=8 and 16), 32, 160
RAGGED_CHECKS = ((1, 100, 2, 40), (2, 333, 3, 80), (1, 77, 1, 512), (2, 130, 4, 8),
                 (2, 130, 4, 16), (1, 90, 2, 32), (1, 70, 2, 160), (1, 1000, 1, 512),
                 (3, 47, 2, 48))
# the shapes at which phase 2 also feeds inputs that randn's nearly uniform
# softmax cannot stand in for: the four head dims of the edit's path
STRESS_SHAPES = ((2, 4096, 8, 40), (2, 1024, 8, 80), (2, 256, 8, 160), (1, 4096, 1, 512))

# (name, (B, N, H, D), launches of each backward kernel per v1 training step):
# the UNet self-attention at batch 4. Under remat the forward kernel runs
# twice per step at each (once more in the backward's recompute), and the
# frozen VAE's mid attention (4, 4096, 1, 512) twice (the two encodes).
TRAIN_SHAPES = (
    ("unet_ds1", (4, 4096, 8, 40), 5),
    ("unet_ds2", (4, 1024, 8, 80), 5),
    ("unet_ds4", (4, 256, 8, 160), 5),
    ("unet_ds8", (4, 64, 8, 160), 1),
)
BWD_PER_STEP = sum(s[2] for s in TRAIN_SHAPES)  # 16 each of dQ and dK/dV
FWD_PER_STEP = 2 * BWD_PER_STEP + 2             # 34
VAE_TRAIN_SHAPE = (4, 4096, 1, 512)  # the frozen VAE's mid attention, 2 a step
# bf16 tolerance of the backward kernels vs their plain versions, relative
# to the gradient's scale: both round P and dS to bf16 at the same points
# and differ only in the order of the fp32 sums (and in the ulp of S that
# order moves), so an element may land a few bf16 ulps away, never more.
GRAD_MAX_REL = 2.0 ** -5
GRAD_L2_REL = 1e-2
# the backward kernels beyond the training shapes: N that no q or key tile
# divides at every padded head dim (48, 80, 16, 32, 160), and N below one
# tile
BWD_CHECKS = ((1, 100, 2, 40), (2, 333, 3, 80), (2, 130, 4, 16), (1, 90, 2, 32),
              (1, 70, 2, 160), (3, 47, 2, 48))

# K3 and K4 beyond the benchmark's shapes: ds8, N that no tile divides, head
# dims 16 and 512; K3 runs each at clusters of 1, 2 and 4, so a cluster's
# last q tiles lie wholly past N ((1,100,2,40): 2 q tiles of 64, (1,77,1,512):
# 3 of 32, (2,333,3,80): 6 of 64)
VARIANT_CHECKS = ((2, 64, 8, 160), (1, 100, 2, 40), (2, 333, 3, 80), (1, 70, 2, 160),
                  (2, 130, 4, 16), (1, 1000, 2, 80), (1, 4000, 2, 40), (1, 77, 1, 512))


def log(*a):
    print(*a, flush=True)


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


def graph_ms(fn, iters: int, stream=None) -> float:
    """Device time of one fn() call: `iters` calls captured into one CUDA
    graph, replayed between two CUDA events. Back-to-back eager launches
    of the small shapes (ds4, ds8) run at the host's launch rate, which
    this takes out for the kernel, its plain version and SDPA alike.
    `stream` (default: a new one) is where fn is warmed up and captured:
    an autograd backward runs on its forward's stream, so a backward is
    captured on the stream its forward ran on."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def phase_build():
    """Every kernel source, one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from pbe_tpu_torch.ops import cuda_build

    def timed_build(name):
        t = time.perf_counter()
        cuda_build.build(name)
        return f"{name}.cu {time.perf_counter() - t:.1f} s"

    from pbe_tpu_torch.scripts.sweep_flash_tiles import ptxas_report

    t0 = time.perf_counter()
    names = ("flash_fwd", "flash_variants", "flash_bwd")
    with ThreadPoolExecutor(len(names)) as pool:
        each = list(pool.map(timed_build, names))
    log(f"[build] {', '.join(n + '.cu' for n in names)} built side by side in "
        f"{time.perf_counter() - t0:.1f} s ({', '.join(each)})")
    for n in names:
        log(f"[build] {n}.cu registers and spills (ptxas):\n"
            f"{ptxas_report(cuda_build.build_log(n))}")


def check_flash(fa, q, k, v, label: str) -> tuple[float, float]:
    """flash_fwd against its plain version on the same inputs -> (max abs
    err of O, max abs err of the LSE); raises past the tolerances above."""
    return compare_flash(fa.flash_fwd(q, k, v, return_lse=True),
                         fa.flash_attention_plain(q, k, v, return_lse=True), label)


def compare_flash(got, want, label: str) -> tuple[float, float]:
    """(O, LSE) of a kernel against (O, LSE) of the plain version; raises
    past the tolerances above."""
    import torch

    (out, lse), (want, want_lse) = got, want
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
    del out, lse, diff
    torch.cuda.synchronize()
    return err, lerr


def rising_scores(shape, gen):
    """q and k (bf16, on the card) whose scores grow with the key's position:
    q[..., 0] = 1 and k[:, j, :, 0] = j * 0.02 / (d^-1/2 log2 e), so a score
    rises by 0.02 a key in the exp2 domain (1.28 a 64-key tile), far above
    the other columns' noise (0.1 randn each): every key tile raises the row
    max, and O is rescaled at every tile."""
    import torch

    from pbe_tpu_torch.ops.flash_attention import LOG2E

    n, d = shape[1], shape[3]
    q = 0.1 * torch.randn(shape, generator=gen, device="cuda")
    k = 0.1 * torch.randn(shape, generator=gen, device="cuda")
    q[..., 0] = 1.0
    step = 0.02 / (d ** -0.5 * LOG2E)
    k[..., 0] = (torch.arange(n, device="cuda", dtype=torch.float32) * step)[None, :, None]
    return q.to(torch.bfloat16), k.to(torch.bfloat16)


def check_stress(fa, rand, gen) -> None:
    """flash_fwd where a wrong rescale cannot hide (with randn inputs at
    N=4096 the softmax is nearly uniform, |O| ~ 0.02): peaked scores (q and
    k x8), a row max that rises at every key tile, and q, k, v as the three
    strided views of one packed (B, N, 3, H, D) tensor, as the UNet hands
    them over; the same tolerances as every other check."""
    import torch

    for shape in STRESS_SHAPES:
        b, n, h, d = shape
        q, k, v = rand(shape), rand(shape), rand(shape)
        check_flash(fa, q * 8, k * 8, v, f"peaked (q, k x8) {shape}")
        qr, kr = rising_scores(shape, gen)
        check_flash(fa, qr, kr, v, f"rising max {shape}")
        q, k, v = rand((b, n, 3, h, d)).unbind(2)
        check_flash(fa, q, k, v, f"packed qkv views {shape} strides {q.stride()}")
        del q, k, v, qr, kr
        torch.cuda.empty_cache()


def phase_kernels() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from pbe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    # masking and padding beyond the main-path shapes: ragged N, every
    # padded head dim
    for shape in RAGGED_CHECKS:
        check_flash(fa, rand(shape), rand(shape), rand(shape), f"check {shape}")
    check_stress(fa, rand, gen)

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
               "ms": graph_ms(lambda: fa.flash_fwd(q, k, v), 20),
               "plain_ms": graph_ms(lambda: fa.flash_attention_plain(q, k, v), 5),
               "bound_ms": binding[1],
               "bound_by": "bytes" if binding[0] == "bytes" else "operations",
               "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20),
               "eager_ms": cuda_ms(lambda: fa.flash_fwd(q, k, v), 20)}
        log(f"[kernel] {name}: kernel {row['ms']:.4f} ms ({row['eager_ms']:.4f} launched "
            f"eagerly), plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms by {binding[0]} (mma {t_mma:.4f}, exp2 "
            f"{t_exp2:.4f}, bytes {t_bytes:.4f})")
        rows.append(row)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def check_bwd(fa, q, k, v, do, label: str) -> dict:
    """The dQ and dK/dV kernels against their plain versions on the same
    inputs (O and the LSE from the forward kernel) -> {output: (max abs
    err, max|g|, rel L2)}; raises past the tolerances above."""
    import torch

    out, lse = fa.flash_fwd(q, k, v, return_lse=True)
    dd = fa.rowsum_do_o(do, out)
    launch = lambda: (fa.flash_bwd_dq(q, k, v, do, lse, dd),
                      *fa.flash_bwd_dkv(q, k, v, do, lse, dd))
    got = launch()
    want = (fa.flash_bwd_dq_plain(q, k, v, do, lse, dd),
            *fa.flash_bwd_dkv_plain(q, k, v, do, lse, dd))
    # every output tile has one owner and no atomics: a second launch on
    # the same inputs gives the same bits
    if not all(torch.equal(a, b) for a, b in zip(got, launch())):
        raise AssertionError(f"flash backward kernels are not bitwise repeatable at {label}")
    torch.cuda.synchronize()
    res, ok = {}, True
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        diff = g.float() - w.float()
        err, scale = diff.abs().max().item(), w.float().abs().max().item()
        rel_l2 = (diff.norm() / w.float().norm()).item()
        res[name] = (err, scale, rel_l2)
        ok = ok and err <= GRAD_MAX_REL * scale and rel_l2 <= GRAD_L2_REL
    log(f"[bwd] {label} (repeat bitwise equal): " + "; ".join(
        f"{n} max|err| {e:.3e} (max|g| {m:.3e}, tol {GRAD_MAX_REL * m:.3e}) rel L2 {r:.3e}"
        for n, (e, m, r) in res.items()) + f" (tol {GRAD_L2_REL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash backward kernels disagree with their plain versions "
                             f"at {label}")
    return res


def bound(flop_per_n2d: float, b: int, n: int, h: int, d: int, nbytes: float):
    """(least ms, binding term) for B*H*N^2*D*flop_per_n2d tensor-core FLOP,
    B*H*N^2 exponentials and nbytes of device memory traffic."""
    terms = (("mma", flop_per_n2d * b * h * n * n * d / BF16_FLOP_PER_S * 1e3),
             ("exp2", 1.0 * b * h * n * n / EXP2_PER_S * 1e3),
             ("bytes", nbytes / HBM_BYTES_PER_S * 1e3))
    return max(terms, key=lambda x: x[1])


def phase_train_kernels() -> list[dict]:
    """The backward kernels, and the forward kernel with the LSE, at the
    v1 training shapes (plus ragged and odd ones for the backward): each
    against its plain version, then timed beside it and beside SDPA."""
    import torch
    import torch.nn.functional as F

    from pbe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(10)
    rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    for shape in BWD_CHECKS:
        check_bwd(fa, rand(shape), rand(shape), rand(shape), rand(shape), f"check {shape}")
    # where a wrong register layout or prescale cannot hide behind randn's
    # nearly uniform P: peaked scores (q and k x8, P nearly one-hot) and q,
    # k, v as the strided views of one packed (B, N, 3, H, D) tensor
    for _, shape, _ in TRAIN_SHAPES:
        b, n, h, d = shape
        q, k, v, do = (rand(shape) for _ in range(4))
        check_bwd(fa, q * 8, k * 8, v, do, f"peaked (q, k x8) {shape}")
        q, k, v = rand((b, n, 3, h, d)).unbind(2)
        check_bwd(fa, q, k, v, do, f"packed qkv views {shape} strides {q.stride()}")
        del q, k, v, do
        torch.cuda.empty_cache()

    rows = []
    for name, shape, per_step in TRAIN_SHAPES:
        b, n, h, d = shape
        q, k, v, do = (rand(shape) for _ in range(4))
        errs = check_bwd(fa, q, k, v, do, f"{name} {shape}")
        ferr, flerr = check_flash(fa, q, k, v, f"{name} fwd+lse {shape}")
        out, lse = fa.flash_fwd(q, k, v, return_lse=True)
        dd = fa.rowsum_do_o(do, out)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dot = do.transpose(1, 2)
        # SDPA's backward alone: the gradient of one saved output, taken on
        # the stream its forward ran on and captured there
        sdpa_stream = torch.cuda.Stream()
        sdpa_stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(sdpa_stream):
            o_sdpa = F.scaled_dot_product_attention(qt, kt, vt)
        sdpa_bwd_ms = graph_ms(lambda: torch.autograd.grad(o_sdpa, (qt, kt, vt), dot,
                                                           retain_graph=True),
                               20, stream=sdpa_stream)
        bnhd, bhn = b * n * h * d * 2, b * h * n * 4
        common = {"route": "cuda", "source": "pbe_tpu_torch/csrc/flash_bwd.cu"}
        for kname, replaces, flop, nbytes, launch, plain in (
                ("flash_bwd_dq", K5, 6.0, 5 * bnhd + 2 * bhn,
                 lambda: fa.flash_bwd_dq(q, k, v, do, lse, dd),
                 lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, dd)),
                ("flash_bwd_dkv", K6, 8.0, 6 * bnhd + 2 * bhn,
                 lambda: fa.flash_bwd_dkv(q, k, v, do, lse, dd),
                 lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, dd))):
            by, ms_bound = bound(flop, b, n, h, d, nbytes)
            outs = ("dq",) if kname == "flash_bwd_dq" else ("dk", "dv")
            rows.append({"name": f"{kname}/{name}", **common, "replaces": replaces,
                         "launches": None, "expected_launches_per_step": per_step,
                         "max_abs_err": max(errs[o][0] for o in outs),
                         "max_abs_g": max(errs[o][1] for o in outs),
                         "rel_l2": max(errs[o][2] for o in outs),
                         "ms": graph_ms(launch, 20), "plain_ms": graph_ms(plain, 3),
                         "bound_ms": ms_bound,
                         "bound_by": "bytes" if by == "bytes" else "operations",
                         # SDPA's whole backward (dQ, dK and dV), the yardstick
                         # of the two kernels' sum
                         "library_ms": sdpa_bwd_ms, "eager_ms": cuda_ms(launch, 20)})
        by, ms_bound = bound(4.0, b, n, h, d, 4 * bnhd + bhn)
        rows.append({"name": f"flash_fwd_lse/{name}_train", "route": "cuda",
                     "source": "pbe_tpu_torch/csrc/flash_fwd.cu", "replaces": K1,
                     "launches": None, "expected_launches_per_step": 2 * per_step,
                     "max_abs_err": ferr, "lse_max_abs_err": flerr,
                     "ms": graph_ms(lambda: fa.flash_fwd(q, k, v, return_lse=True), 20),
                     "plain_ms": graph_ms(lambda: fa.flash_attention_plain(
                         q, k, v, return_lse=True), 3),
                     "bound_ms": ms_bound,
                     "bound_by": "bytes" if by == "bytes" else "operations",
                     "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                            20)})
        dq_row, dkv_row, f_row = rows[-3:]
        log(f"[bwd] {name} {shape} (graph-timed): dq {dq_row['ms']:.4f} ms (eager "
            f"{dq_row['eager_ms']:.4f}, plain {dq_row['plain_ms']:.4f}, bound "
            f"{dq_row['bound_ms']:.4f}); dkv {dkv_row['ms']:.4f} ms (eager "
            f"{dkv_row['eager_ms']:.4f}, plain {dkv_row['plain_ms']:.4f}, bound "
            f"{dkv_row['bound_ms']:.4f}); pair {dq_row['ms'] + dkv_row['ms']:.4f} ms vs SDPA "
            f"backward {sdpa_bwd_ms:.4f} ms; fwd+lse {f_row['ms']:.4f} ms (plain "
            f"{f_row['plain_ms']:.4f}, SDPA {f_row['library_ms']:.4f}, bound "
            f"{f_row['bound_ms']:.4f})")
        del q, k, v, do, out, lse, dd, qt, kt, vt, dot, o_sdpa
        torch.cuda.empty_cache()

    # K2 at the frozen VAE's mid attention in the training step (no LSE)
    b, n, h, d = VAE_TRAIN_SHAPE
    q, k, v = (rand(VAE_TRAIN_SHAPE) for _ in range(3))
    err, lerr = check_flash(fa, q, k, v, f"vae_mid_train {VAE_TRAIN_SHAPE}")
    by, ms_bound = bound(4.0, b, n, h, d, 4 * b * n * h * d * 2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rows.append({"name": "flash_fwd/vae_mid_train", "route": "cuda",
                 "source": "pbe_tpu_torch/csrc/flash_fwd.cu", "replaces": K2,
                 "launches": None, "expected_launches_per_step": 2,
                 "max_abs_err": err, "lse_max_abs_err": lerr,
                 "ms": graph_ms(lambda: fa.flash_fwd(q, k, v), 20),
                 "plain_ms": graph_ms(lambda: fa.flash_attention_plain(q, k, v), 3),
                 "bound_ms": ms_bound, "bound_by": "bytes" if by == "bytes" else "operations",
                 "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                        20)})
    r = rows[-1]
    log(f"[bwd] vae_mid_train {VAE_TRAIN_SHAPE}: fwd {r['ms']:.4f} ms (plain "
        f"{r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by {by})")
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def phase_variants() -> list[dict]:
    """K3 (resident) and K4 (pipelined) against the plain version at
    VARIANT_CHECKS; at the attention benchmark's shapes, every
    flash_forward(variant=...) call against the plain version with one
    launch of the matching kernel and of no other, K3 and K4 on rising
    scores and at each key block (and K3 at each cluster size); kernel
    (CUDA-graph timed), plain and SDPA times and the function's bound; then
    the bench entry over every shape and impl, with every kernel's count set
    to 0 just before and read just after."""
    import torch
    import torch.nn.functional as F

    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.scripts import bench_attention as bench

    gen = torch.Generator(device="cuda").manual_seed(20)
    rand = lambda shape: torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    kernels = {"resident": fa.flash_fwd_resident, "pipelined": fa.flash_fwd_pipelined}
    blocks = {"resident": fa.RESIDENT_BLOCKS, "pipelined": fa.PIPELINED_BLOCKS}

    def every_launch(variant, dp):
        """(label, kwargs) of every key block, and for K3 every cluster size"""
        clusters = fa.CLUSTER_SIZES if variant == "resident" else (None,)
        return [(f"block {blk}" + (f" cluster {c}" if c else ""), {"block": blk, "cluster": c}
                 if c else {"block": blk}) for blk in blocks[variant][dp] for c in clusters]

    def check_all(q, k, v, label):
        """every launch of K3 and K4 on (q, k, v) -> {variant: (max err, max lse err)}"""
        want = fa.flash_attention_plain(q, k, v, return_lse=True)
        dp = (q.shape[3] + 15) // 16 * 16
        errs = {}
        for variant, kern in kernels.items():
            e = [compare_flash(kern(q, k, v, return_lse=True, **kw), want,
                               f"{variant} {label} {tuple(q.shape)} {what}")
                 for what, kw in every_launch(variant, dp)]
            errs[variant] = (max(x for x, _ in e), max(y for _, y in e))
        return errs

    for shape in VARIANT_CHECKS:
        check_all(rand(shape), rand(shape), rand(shape), "check")

    fwd_kernels = (fa.flash_fwd, fa.flash_fwd_resident, fa.flash_fwd_pipelined)
    kernel_of = {"resident": 1, "pipelined": 2}  # index in fwd_kernels; others 0
    rows = []
    for name, shape in bench.SHAPES.items():
        b, n, h, d = shape
        dp = (d + 15) // 16 * 16
        q, k, v = rand(shape), rand(shape), rand(shape)
        want = fa.flash_attention_plain(q, k, v, return_lse=True)
        # every flash_forward(variant=...) call: the plain version's O and
        # LSE, and one launch of its kernel
        for variant in fa.VARIANTS:
            before = [x.launches for x in fwd_kernels]
            compare_flash(fa.flash_forward(q, k, v, variant=variant, return_lse=True),
                          want, f"flash_forward(variant={variant!r}) {name} {shape}")
            diff = [x.launches - b0 for x, b0 in zip(fwd_kernels, before)]
            if diff != [int(i == kernel_of.get(variant, 0)) for i in range(3)]:
                raise AssertionError(f"flash_forward(variant={variant!r}) at {shape} launched "
                                     f"{diff} of (flash_fwd, resident, pipelined)")
        log(f"[variants] {name}: each flash_forward variant launched its own kernel once")
        # K4's pass-1 max and K3's rescale where every key tile raises the
        # row max; then every key block and cluster size on randn inputs
        qr, kr = rising_scores(shape, gen)
        check_all(qr, kr, v, "rising max")
        del qr, kr
        errs = check_all(q, k, v, name)

        plain_ms = graph_ms(lambda: fa.flash_attention_plain(q, k, v), 3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
        by, ms_bound = bound(4.0, b, n, h, d, 4 * b * n * h * d * 2)
        for variant, kern in kernels.items():
            row = {"name": f"flash_fwd_{variant}/{name}", "route": "cuda",
                   "source": "pbe_tpu_torch/csrc/flash_variants.cu",
                   "replaces": K3 if variant == "resident" else K4, "launches": None,
                   "max_abs_err": errs[variant][0], "lse_max_abs_err": errs[variant][1],
                   "ms": graph_ms(lambda: kern(q, k, v), 20), "plain_ms": plain_ms,
                   "bound_ms": ms_bound, "bound_by": "bytes" if by == "bytes" else "operations",
                   "library_ms": sdpa_ms, "block": fa.key_block(variant, d)}
            extra = ""
            if variant == "resident":
                row["cluster"] = fa.resident_cluster(
                    shape, sms=torch.cuda.get_device_properties(0).multi_processor_count)
                row["cluster_ms"] = {c: graph_ms(lambda: kern(q, k, v, cluster=c), 20)
                                     for c in fa.CLUSTER_SIZES}
                extra = (f", cluster {row['cluster']}; at C = 1/2/4: "
                         + " / ".join(f"{t:.4f}" for t in row["cluster_ms"].values()))
            else:
                # the second QK^T: 6*BH*N^2*DP tensor-core FLOP in all, a
                # floor the run computes (the row holds measured times only)
                floor_ms = 6.0 * b * h * n * n * dp / BF16_FLOP_PER_S * 1e3
                extra = f", product floor {floor_ms:.4f}"
            log(f"[variants] {variant} {name} {shape} (block {row['block']}{extra}): "
                f"{row['ms']:.4f} ms (graph), plain {plain_ms:.4f}, SDPA {sdpa_ms:.4f}, "
                f"bound {ms_bound:.4f} by {by}")
            rows.append(row)
        del q, k, v, qt, kt, vt, want
        torch.cuda.empty_cache()

    # this slice's path: the bench entry, every kernel's count from 0
    every = (*fwd_kernels, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for kern in every:
        kern.launches = 0
        kern.launches_by_shape.clear()
    t0 = time.perf_counter()
    bench.main(["--repeats", "10"])
    counts = {kern.symbol: (kern.launches, dict(kern.launches_by_shape)) for kern in every}
    log(f"[variants] bench entry in {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps({s: c[0] for s, c in counts.items()})}")
    if not all(kern.launches for kern in fwd_kernels) or fa.flash_bwd_dq.launches \
            or fa.flash_bwd_dkv.launches:
        raise AssertionError("the bench entry did not launch every forward kernel, or "
                             "launched a backward one")
    for row in rows:
        kern = kernels[row["name"].split("/")[0].removeprefix("flash_fwd_")]
        row["launches"] = counts[kern.symbol][1].get(bench.SHAPES[row["name"].split("/")[1]], 0)
        if not row["launches"]:
            raise AssertionError(f"{row['name']}: no launch on the bench entry's path")
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


DEV_MS = lambda e: getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0)) / 1e3


def kernel_group(name: str) -> str:
    n = name.lower()
    return ("flash_fwd" if "flash_fwd" in n else
            "flash_bwd_dq" if "flash_bwd_dq" in n else
            "flash_bwd_dkv" if "flash_bwd_dkv" in n else
            "optimizer (adamw, grad norm)" if "multi_tensor" in n or "adam" in n else
            "layout (nchw<->nhwc)" if "nchwtonhwc" in n or "nhwctonchw" in n else
            "conv" if any(s in n for s in ("conv", "fprop", "implicit", "dgrad", "wgrad")) else
            "gemm" if any(s in n for s in ("gemm", "nvjet", "cublas", "cutlass")) else
            "norm" if "norm" in n or "moments" in n else
            "copy/cast" if "copy" in n else "elementwise/other")


def device_time(prof):
    """Device-side kernels of a profile, slowest first, their summed time
    (ms) and that time by kernel_group; the CPU ops' entries, and the user
    annotations drawn on the device timeline (Optimizer.step#AdamW.step),
    repeat their kernels' time and are left out."""
    from torch.autograd import DeviceType

    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and DEV_MS(e) > 0
                      and not getattr(e, "is_user_annotation", False)),
                     key=DEV_MS, reverse=True)
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    groups: dict[str, float] = {}
    for e in kernels:
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + DEV_MS(e)
    return kernels, sum(DEV_MS(e) for e in kernels), groups


def phase_profile(model) -> None:
    """Where one warm v1 CFG UNet call spends the card's time: device time
    by kernel (torch.profiler) and the device's idle share, taken against
    the call's wall time without the profiler (which slows the host)."""
    import torch
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
    kernels, busy, groups = device_time(prof)
    log(f"[profile] v1 CFG UNet call x{calls}: wall {plain_wall_ms / calls:.3f} ms/call "
        f"({wall_ms / calls:.3f} under the profiler), device busy {busy / calls:.3f} "
        f"ms/call, idle share {1 - busy / plain_wall_ms:.3f}")
    log(f"[profile] by group (ms/call): "
        f"{json.dumps({k: round(v / calls, 4) for k, v in sorted(groups.items())})}")
    for e in kernels[:15]:
        log(f"[profile]   {DEV_MS(e) / calls:9.4f} ms/call  x{e.count // calls:4d}  "
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
    variants = (fa.flash_fwd_resident, fa.flash_fwd_pipelined)
    for kern in (fa.flash_fwd, *variants):
        kern.launches = 0
        kern.launches_by_shape.clear()
    t0 = time.perf_counter()
    out = pipe.edit_batch(image, mask, ref, steps=50, scale=5.0, seed=3)
    first_s = time.perf_counter() - t0
    launches = fa.flash_fwd.launches
    by_shape = dict(fa.flash_fwd.launches_by_shape)
    log(f"[edit] 512^2 50-step PLMS scale 5 batch 1: first edit {first_s:.3f} s, "
        f"flash launches {launches} (expected {LAUNCHES_PER_EDIT}), by shape {by_shape}; "
        f"resident {variants[0].launches}, pipelined {variants[1].launches} (expected 0)")
    if any(kern.launches for kern in variants):
        raise AssertionError("the edit launched the resident or pipelined kernel")
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
    # the block=False handle the reference's server polls: is_ready() turns
    # True within a time limit, and the host copy is the blocking edit's
    kw = dict(steps=10, scale=5.0, seed=9)
    pending = pipe.edit_batch(image, mask, ref, block=False, **kw)
    t0 = time.perf_counter()
    polls = 1
    while not pending.is_ready():
        if time.perf_counter() - t0 > 120.0:
            raise AssertionError("a block=False edit was not ready within 120 s")
        time.sleep(0.001)
        polls += 1
    ready_s = time.perf_counter() - t0
    got = np.asarray(pending)
    want = pipe.edit_batch(image, mask, ref, **kw)
    log(f"[edit] block=False 10-step edit: ready after {polls} polls, {ready_s:.4f} s after "
        f"edit_batch returned; equal to block=True: {np.array_equal(got, want)}")
    if not np.array_equal(got, want):
        raise AssertionError("the block=False edit differs from the block=True edit")
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


def build_v1_for_training():
    """configs/v1.yaml at full width on the card, bf16, flash attention and
    remat (use_checkpoint), random weights with the zero-init heads
    randomized so that every layer gets a gradient. At scale 0.02 the eps
    of random inputs has rms 0.57 (0.29 at 0.01, 2.6 at 0.1; measured on
    the card), so the eps-MSE against a unit-variance target starts near
    1 + 0.57^2."""
    import torch

    from pbe_tpu_torch.models.pbe import build_from_yaml
    from pbe_tpu_torch.pipelines.loading import init_parameters, randomize_zero_params

    t0 = time.perf_counter()
    model, _ = build_from_yaml("configs/v1.yaml", dtype=torch.bfloat16, attn_impl="flash",
                               device="cuda")
    init_parameters(model, seed=0)
    randomize_zero_params(model, seed=0, scale=0.02)
    torch.cuda.synchronize()
    log(f"[train] v1 built for training (remat {model.model.diffusion_model.remat}) in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def phase_unet_grad(model) -> None:
    """One v1 UNet eps-MSE at batch 4 (64^2 latent, bf16) backpropagated
    through the flash autograd function and through plain attention; the
    gradients over the UNet's parameters compared as one vector."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(11)
    x9 = torch.randn((4, 64, 64, 9), generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((4, 1, 768), generator=gen, device="cuda").to(torch.bfloat16)
    noise = torch.randn((4, 64, 64, 4), generator=gen, device="cuda")
    t = torch.tensor([10, 300, 600, 990], device="cuda")
    params = list(model.model.diffusion_model.parameters())

    def grad(impl):
        set_attn_impl(model, impl)
        loss = (model.apply_model(x9, t, ctx).float() - noise).square().mean()
        # attn2's norm2 gets none: one context token makes attn2 ignore it
        g = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        return loss.item(), torch.cat([x.float().flatten() for x in g])

    loss_f, g_flash = grad("flash")
    loss_p, g_plain = grad("plain")
    set_attn_impl(model, "flash")
    rel = ((g_flash - g_plain).norm() / g_plain.norm()).item()
    finite = bool(torch.isfinite(g_flash).all())
    # bf16 through 16 transformer and 25 res blocks, forward and backward:
    # P and dS are rounded to bf16 at other points than in the plain
    # einsum path (2^-8), which the residual streams carry; a wrong
    # backward kernel gives O(1)
    log(f"[grad] v1 UNet loss batch 4 bf16: loss flash {loss_f:.5f} plain {loss_p:.5f}; "
        f"global gradient over {len(params)} tensors ({g_plain.numel()} values) flash vs "
        f"plain rel L2 {rel:.3e} (tol 5e-2), |g| {g_plain.norm().item():.4e}")
    if not (finite and rel <= 5e-2):
        raise AssertionError("the v1 UNet gradient through the flash kernels disagrees "
                             "with plain attention")
    del g_flash, g_plain
    torch.cuda.empty_cache()


def train_batches(n: int, size: int, ref_size: int, batch: int, seed: int) -> list[dict]:
    """Seeded numpy batches as scripts/bench_train.py makes them: image
    U[-1,1], a square hole in the mask, ref N(0,1)."""
    g = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        image = g.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
        mask = np.ones((batch, size, size, 1), np.float32)
        mask[:, size // 4:3 * size // 4, size // 4:3 * size // 4] = 0.0
        ref = g.standard_normal((batch, ref_size, ref_size, 3)).astype(np.float32)
        out.append({"image": image, "inpaint_image": image * mask, "mask": mask, "ref": ref})
    return out


def phase_train(model, card: str, rows: list[dict]) -> dict:
    """The slice: Trainer.fit on v1 at full width, batch 4, 512^2: 4 warm
    steps, then 12 steps with every kernel's launch count set to 0 just
    before and read just after, timed by CUDA events recorded as the
    trainer pulls each batch (no host sync inside the run: the one metric
    log falls on the last step)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pbe_tpu_torch.ops import flash_attention as fa
    from pbe_tpu_torch.training.trainer import Trainer

    warm, steps = 4, 12
    batches = train_batches(warm + steps, 512, 224, 4, seed=12)
    with tempfile.TemporaryDirectory() as logdir:
        trainer = Trainer(model, logdir=logdir, seed=0)
        frozen = [p for p in model.parameters() if not p.requires_grad]
        checksum = lambda: torch.stack([torch.stack([p.double().sum(), p.double().square().sum()])
                                        for p in frozen]).cpu()
        before = checksum()
        t0 = time.perf_counter()
        trainer.fit(batches[:warm], max_steps=warm, log_every=warm, ckpt_every=10**9)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0

        events = []

        def timed(bs):
            for b in bs:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
                yield b

        kernels = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_fwd_resident,
                   fa.flash_fwd_pipelined)
        for k in kernels:
            k.launches = 0
            k.launches_by_shape.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.fit(timed(batches[warm:]), max_steps=warm + steps,
                    log_every=warm + steps, ckpt_every=10**9)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = {k.symbol: (k.launches, dict(k.launches_by_shape)) for k in kernels}
        peak = torch.cuda.max_memory_allocated()
        with open(trainer.logger.path) as f:
            last = json.loads(f.readlines()[-1])
        after = checksum()

        # step i's time: from batch i+1's pull to batch i+2's (one batch ahead)
        step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(1, len(events) - 1)]
        p50 = float(np.median(step_ms))
        log(f"[train] v1 batch 4 512^2 Trainer.fit: {warm} warm steps {warm_s:.2f} s; "
            f"{steps} steps {wall_s:.3f} s wall; step ms {['%.2f' % t for t in step_ms]}: "
            f"p50 {p50:.3f} ms, {4e3 / p50:.4f} images/s; peak memory "
            f"{peak / 2**30:.3f} GiB ({card})")
        log(f"[train] last step: loss {last['train/loss']:.5f} grad_norm "
            f"{last['train/grad_norm']:.5f} loss_vlb {last['train/loss_vlb']:.6f} (step "
            f"{last['step']})")
        log(f"[train] launches in {steps} steps: {json.dumps({k: v[0] for k, v in counts.items()})}; "
            f"by shape {counts}")
        if not (np.isfinite(last["train/loss"]) and np.isfinite(last["train/grad_norm"])
                and 0.5 <= last["train/loss"] <= 2.0):
            raise AssertionError(f"training loss {last['train/loss']} or grad_norm "
                                 f"{last['train/grad_norm']} out of range")
        if not torch.equal(before, after):
            raise AssertionError("a frozen parameter changed during training")
        state = trainer.optimizer.state
        trainable = list(trainer.params.values())
        if not (len(state) == len(trainable) and all("exp_avg" in state[p] for p in trainable)
                and not any(p in state for p in frozen)):
            raise AssertionError("AdamW state is not exactly the trainable parameters'")
        log(f"[train] frozen parameters unchanged ({len(frozen)} tensors); AdamW state for "
            f"all {len(trainable)} trainable tensors and no frozen one")
        per_step = {"pbe_flash_fwd_bf16": FWD_PER_STEP, "pbe_flash_bwd_dq_bf16": BWD_PER_STEP,
                    "pbe_flash_bwd_dkv_bf16": BWD_PER_STEP, "pbe_flash_resident_bf16": 0,
                    "pbe_flash_pipelined_bf16": 0}
        for sym, want in per_step.items():
            if counts[sym][0] != want * steps:
                raise AssertionError(f"{sym}: {counts[sym][0]} launches in {steps} steps, "
                                     f"expected {want} per step")
        sym_of = {"flash_bwd_dq": "pbe_flash_bwd_dq_bf16",
                  "flash_bwd_dkv": "pbe_flash_bwd_dkv_bf16",
                  "flash_fwd_lse": "pbe_flash_fwd_bf16", "flash_fwd": "pbe_flash_fwd_bf16"}
        shape_of = {**{n: sh for n, sh, _ in TRAIN_SHAPES}, "vae_mid": VAE_TRAIN_SHAPE}
        for row in rows:
            kname, sname = row["name"].split("/")
            shape = shape_of[sname.removesuffix("_train")]
            n = counts[sym_of[kname]][1].get(shape, 0)
            want = row.pop("expected_launches_per_step")
            if n != want * steps:
                raise AssertionError(f"{row['name']}: {n} launches in {steps} steps, "
                                     f"expected {want} per step")
            row["launches"] = n // steps  # per training step
            row["launches_in_run"], row["run_steps"] = n, steps

        # where one step's device time goes: one more step under the
        # profiler, against the unprofiled p50
        dbatch = trainer._put_batch(batches[-1])
        trainer.train_step(dbatch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.train_step(dbatch)
            torch.cuda.synchronize()
        kern, busy, groups = device_time(prof)
        log(f"[train-profile] one step: device busy {busy:.3f} ms, idle share "
            f"{1 - busy / p50:.3f} of the p50 step")
        log(f"[train-profile] by group (ms/step): "
            f"{json.dumps({k: round(v, 4) for k, v in sorted(groups.items())})}")
        for e in kern[:15]:
            log(f"[train-profile]   {DEV_MS(e):9.4f} ms/step  x{e.count:4d}  {e.key[:110]}")
        trainer.logger.close()
    return {"step_ms": step_ms, "p50_ms": p50, "images_per_s": 4e3 / p50,
            "peak_gib": peak / 2**30, "loss": last["train/loss"],
            "grad_norm": last["train/grad_norm"], "device_busy_ms": busy,
            "idle_share": 1 - busy / p50, "groups_ms": groups}


def phase_train_reference() -> None:
    """configs/tiny.yaml: 3 train steps on the card (bf16, the kernels)
    against the same steps on the CPU (fp32, the kernels' plain versions):
    the same seeded weights, batches and draws, the posterior mode, a
    constant LR multiplier."""
    import torch

    from pbe_tpu_torch.models.pbe import build_from_yaml
    from pbe_tpu_torch.pipelines.loading import init_parameters, randomize_zero_params
    from pbe_tpu_torch.training.partition import split_parameters
    from pbe_tpu_torch.training.train_step import make_optimizer, train_step

    gpu, _ = build_from_yaml("configs/tiny.yaml", dtype=torch.bfloat16, attn_impl="flash",
                             device="cuda")
    init_parameters(gpu, seed=0)
    randomize_zero_params(gpu, seed=0)
    cpu, _ = build_from_yaml("configs/tiny.yaml", dtype=torch.float32, attn_impl="flash",
                             device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    batches = train_batches(3, 64, 224, 2, seed=13)
    g = np.random.default_rng(14)
    n = 64 // gpu.latent_downsample
    draws = [(g.integers(0, 1000, (2,)), g.standard_normal((2, n, n, 4)).astype(np.float32))
             for _ in batches]
    losses = {}
    for name, model, dev in (("card", gpu, "cuda"), ("cpu", cpu, "cpu")):
        params, _ = split_parameters(model)
        opt, sched = make_optimizer(params, base_lr=1e-4, scheduler=lambda n: 1.0)
        out = []
        for batch, (t, noise) in zip(batches, draws):
            tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            m = train_step(model, params, opt, sched, tb, torch.from_numpy(t).to(dev),
                           torch.from_numpy(noise).to(dev), torch.tensor(0.5, device=dev))
            out.append((m["loss"].item(), m["grad_norm"].item()))
        losses[name] = out
    # bf16 activations round each element by up to 2^-8 (3.9e-3); the
    # loss and the gradient norm are sums over thousands of elements, in
    # which that rounding mostly cancels, so they stay well inside 1e-2 of
    # the fp32 values; a wrong kernel, LR step or optimizer state moves
    # them further by the second or third step
    rel = [(abs(a[0] - b[0]) / b[0], abs(a[1] - b[1]) / b[1])
           for a, b in zip(losses["card"], losses["cpu"])]
    log(f"[train-reference] tiny 3 steps, card bf16 vs CPU fp32: (loss, grad_norm) card "
        f"{losses['card']} cpu {losses['cpu']}; rel diff {rel} (tol 1e-2 each)")
    if not all(np.isfinite(x).all() and max(r) <= 1e-2 for x, r in zip(losses["card"], rel)):
        raise AssertionError("card training disagrees with the CPU fp32 reference")


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
    from pbe_tpu_torch.scripts.bench_attention import card_line

    card = card_line()
    log(f"[env] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase_build()
    rows = phase_kernels()
    train_rows = phase_train_kernels()
    variant_rows = phase_variants()
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
    model = build_v1_for_training()
    phase_unet_grad(model)
    train = phase_train(model, card, train_rows)
    del model
    torch.cuda.empty_cache()
    phase_reference()
    phase_train_reference()
    log(f"[edit] summary {json.dumps(edit)}")
    log(f"[train] summary {json.dumps(train)}")
    print(json.dumps({"kernels": rows + train_rows + variant_rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
