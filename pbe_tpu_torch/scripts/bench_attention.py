"""Flash-attention microbenchmark on one card: the port of
``scripts/bench_attention.py``.

    python -m pbe_tpu_torch.scripts.bench_attention [--repeats 20]
        [--impls resident,pipelined] [--shapes unet_ds1,vae_mid]
    python -m pbe_tpu_torch.scripts.bench_attention --device cpu
    PYTHONPATH=<checkout> python pbe_tpu_torch/scripts/bench_attention.py ...

Times every forward variant of ``ops.flash_attention.flash_forward`` at the
UNet self-attention and VAE mid-block shapes of the 512^2 edit at CFG batch
2, beside the plain version: CUDA events around the one replay of a CUDA
graph of ``--repeats`` calls (5 for the plain version), after two warm-up
calls, so the host's launch rate is not in the time. The graph is replayed
once only, so a kernel's launch count (one per wrapper call: 2 + repeats a
line) is the number of times the card ran it. Impls: ``plain``
(``flash_attention_plain``, the counterpart of the JAX script's ``xla``);
``auto`` (the models' kernels, csrc/flash_fwd.cu, which serve both of the
JAX script's ``rowblock`` and ``streamed``, so they are timed once);
``resident`` and ``pipelined`` (csrc/flash_variants.cu), over the key
blocks they instantiate (the resident kernel at its default cluster). The
script reaches the kernels only through ``flash_forward`` and the tables of
key blocks, so, run by path with another checkout first on ``PYTHONPATH``,
it times that checkout's kernels on the same card.

Prints the card's name and power limit on its first line, then one JSON line
per (shape, impl, blocks) with the JAX script's keys (``blocks``: [key
block], or null where the source alone decides the tiles); ``ideal_*_us``
are the products' 4*BH*N^2*d FLOP at ``--peak-tflops`` with d as given and
padded to 16 as the kernels pad it.
``--device cpu`` times the plain version alone at a tiny shape.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from pbe_tpu_torch.ops import flash_attention as fa

# (B, N, H, D): UNet self-attention at the three levels and the VAE mid
# attention, the shapes of scripts/bench_attention.py
SHAPES = {
    "unet_ds1": (2, 4096, 8, 40),
    "unet_ds2": (2, 1024, 8, 80),
    "unet_ds4": (2, 256, 8, 160),
    "vae_mid": (2, 4096, 1, 512),
}
CPU_SHAPES = {"tiny": (1, 64, 2, 40)}
IMPLS = ("plain", "auto", "resident", "pipelined")
PEAK_BF16_TFLOPS = 989.0  # H100 SXM, dense bf16


def configs(shapes: dict, impls) -> list[tuple]:
    """(shape name, impl, blocks [key block] or None) of every line, from
    the shapes alone: nothing is launched."""
    out = []
    for name, (_, _, _, d) in shapes.items():
        for impl in impls:
            if impl in ("plain", "auto"):
                out.append((name, impl, None))
                continue
            table = fa.RESIDENT_BLOCKS if impl == "resident" else fa.PIPELINED_BLOCKS
            out.extend((name, impl, [block]) for block in table[fa._round_up(d, 16)])
    return out


def time_us(fn, repeats: int, device: torch.device) -> float:
    """Mean time of one call: on the card, CUDA events around the one
    replay of a CUDA graph of ``repeats`` calls, after two warm-up calls
    (no warm replay: the card runs fn 2 + repeats times, as many as the
    wrappers count); the host clock on the CPU."""
    if device.type != "cuda":
        fn()
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        return (time.perf_counter() - t0) / repeats * 1e6
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(repeats):
            fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    del graph
    return start.elapsed_time(end) / repeats * 1e3


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--peak-tflops", type=float, default=PEAK_BF16_TFLOPS)
    p.add_argument("--impls", default="",
                   help="comma list to restrict impls (e.g. pipelined,resident)")
    p.add_argument("--shapes", default="",
                   help="comma list to restrict shapes (e.g. unet_ds1)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    opt = p.parse_args(argv)
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_attention: no CUDA device (--device cpu times the plain "
                         "version)")
    impl_filter = set(filter(None, opt.impls.split(",")))
    shape_filter = set(filter(None, opt.shapes.split(",")))
    shapes = {k: s for k, s in (SHAPES if device.type == "cuda" else CPU_SHAPES).items()
              if not shape_filter or k in shape_filter}
    impls = [i for i in (IMPLS if device.type == "cuda" else ("plain",))
             if not impl_filter or i in impl_filter]

    head = ({"card": card_line(), "device": torch.cuda.get_device_name(device)}
            if device.type == "cuda" else {"card": None, "device": "cpu"})
    print(json.dumps(head), flush=True)
    rows, inputs = [], {}
    for name, impl, blocks in configs(shapes, impls):
        b, n, h, d = shapes[name]
        if name not in inputs:
            inputs.clear()  # one shape's q, k, v on the card at a time
            gen = torch.Generator(device=device).manual_seed(0)
            inputs[name] = [torch.randn((b, n, h, d), generator=gen, device=device)
                            .to(torch.bfloat16) for _ in range(3)]
        q, k, v = inputs[name]
        flop = 4.0 * b * h * n * n
        ideal_us = flop * d / (opt.peak_tflops * 1e12) * 1e6
        row = {"shape": name, "bh": b * h, "n": n, "d": d, "impl": impl, "blocks": blocks,
               "us": None, "ideal_unpadded_us": ideal_us,
               "ideal_padded_us": flop * fa._round_up(d, 16) / (opt.peak_tflops * 1e12) * 1e6,
               "mxu_util_vs_unpadded": None, "device": head["device"]}
        if impl == "plain":
            fn = lambda: fa.flash_attention_plain(q, k, v)
        else:
            kw = ({"block_k": blocks[0]} if impl == "resident" else
                  {"block_c": blocks[0]} if impl == "pipelined" else {})
            fn = lambda: fa.flash_forward(q, k, v, variant=impl, **kw)
        row["us"] = time_us(fn, min(opt.repeats, 5) if impl == "plain" else opt.repeats,
                            device)
        row["mxu_util_vs_unpadded"] = ideal_us / row["us"]
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
