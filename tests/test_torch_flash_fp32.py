"""The fp32 side of the port's flash-attention wrappers on the CPU: which
operand dtypes the CUDA path takes, which entry (csrc/flash_fp32.cu or the
bf16 sources) a launch loads, how launches are counted by dtype, which key
blocks the fp32 resident and pipelined kernels take, and the CLIs'
--precision full (fp32 on the card, TF32 off). The fp32 plain versions are
held against the Pallas kernels at fp32 by
tests/test_torch_flash_attention.py, tests/test_torch_flash_variants.py
(every variant, the resident one at d = 512 too) and
tests/test_torch_flash_backward.py; the CUDA kernels against their plain
versions on the card by chip_smoke.py (phases 20 and 11). The fp32
forward's P V runs as 3xTF32 on the tensor cores: an emulation of it in
torch holds it to the plain version at chip_smoke.py's fp32 tolerances,
where 1xTF32 fails them."""
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from pbe_tpu_torch.ops import cuda_build
from pbe_tpu_torch.ops import flash_attention as fa
from pbe_tpu_torch.scripts import inference
from pbe_tpu_torch.scripts.sweep_flash_tiles import ptxas_report

from _torch_port import mma_k8, rel_errors, stress_inputs, tf32, top19

CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"
WRAPPERS = {"fwd": fa.flash_fwd, "dq": fa.flash_bwd_dq, "dkv": fa.flash_bwd_dkv,
            "resident": fa.flash_fwd_resident, "pipelined": fa.flash_fwd_pipelined}
# each wrapper's symbol stem and the source of its bf16 twin
TWINS = {"fwd": ("fwd", "flash_fwd"), "dq": ("bwd_dq", "flash_bwd"),
         "dkv": ("bwd_dkv", "flash_bwd"), "resident": ("resident", "flash_variants"),
         "pipelined": ("pipelined", "flash_variants")}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("which", list(WRAPPERS))
def test_cuda_dtype_check_accepts_bf16_and_fp32(which, dtype):
    x = torch.zeros(1, 8, 1, 40, dtype=dtype)
    kern = WRAPPERS[which]
    assert fa.operand_dtype("k", kern.dtypes, q=x, k=x, v=x) == dtype


@pytest.mark.parametrize("which", list(WRAPPERS))
@pytest.mark.parametrize("case", ["fp16", "mixed", "fp64"])
def test_cuda_dtype_check_rejects_other_and_mixed_dtypes(which, case):
    x = torch.zeros(1, 8, 1, 40)
    others = {"fp16": (x.half(), x.half()), "mixed": (x, x.bfloat16()),
              "fp64": (x.double(), x.double())}[case]
    with pytest.raises(TypeError, match="share one dtype" if case == "mixed" else "takes"):
        fa.operand_dtype("k", WRAPPERS[which].dtypes, q=others[0], k=others[1])


@pytest.mark.parametrize("which", list(WRAPPERS))
def test_an_fp32_launch_loads_the_fp32_entry_and_counts_by_dtype(which, monkeypatch):
    """The entry each dtype loads (a stand-in library records the lookup),
    and the counters: in all, by shape and by dtype, reset to 0."""
    loaded = []

    class Lib:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, symbol):
            loaded.append((self.name, symbol))
            return lambda *args: 0

    kern = (fa.FlashBackward(which) if which in ("dq", "dkv")
            else fa.FlashForward(None if which == "fwd" else which))
    monkeypatch.setattr(cuda_build, "load", Lib)
    shape = (1, 8, 1, 40)
    kern._launch(torch.float32, shape)
    kern._launch(torch.float32, shape)
    kern._launch(torch.bfloat16, shape)
    sym, twin = TWINS[which]
    assert loaded == [("flash_fp32", f"pbe_flash_{sym}_f32"), (twin, f"pbe_flash_{sym}_bf16")]
    assert kern.launches == 3 and kern.launches_by_shape == {shape: 3}
    assert kern.launches_by_dtype == {"float32": 2, "bfloat16": 1}
    kern.reset()
    assert (kern.launches, kern.launches_by_shape, kern.launches_by_dtype) == (0, {}, {})


def test_fp32_source_defines_every_fp32_entry_with_its_twins_arguments():
    """csrc/flash_fp32.cu exports the five symbols the wrappers load, each
    with its bf16 twin's parameter list (the wrappers share argtypes)."""
    def params(path, symbol):
        src = (CSRC / path).read_text()
        m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
        assert m, (path, symbol)
        return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]

    for sym, twin in TWINS.values():
        assert (params("flash_fp32.cu", f"pbe_flash_{sym}_f32")
                == params(f"{twin}.cu", f"pbe_flash_{sym}_bf16"))
    assert cuda_build.library_path("flash_fp32").name.startswith("libflash_fp32-")


def test_fp32_block_tables_plan_and_refuse_by_dtype():
    """The fp32 resident and pipelined kernels instantiate a subset of the
    bf16 key blocks, defaults included; a block only bf16 has runs the
    tuned kernel for bf16 operands and csrc/flash_variants_anyd.cu's for
    fp32 (on the CPU the plain version, at either dtype)."""
    f32 = torch.float32
    for variant in ("resident", "pipelined"):
        bf16_table, f32_table = fa.block_table(variant), fa.block_table(variant, f32)
        assert f32_table.keys() == bf16_table.keys() == set(fa.SUPPORTED_HEAD_DIMS)
        assert all(set(f32_table[dp]) <= set(bf16_table[dp]) for dp in f32_table)
        for dp in fa.SUPPORTED_HEAD_DIMS:
            block = fa.key_block(variant, dp)
            assert block in f32_table[dp] and block in bf16_table[dp]
    for variant, dp, table in (("resident", 80, "RESIDENT_BLOCKS_F32"),
                               ("pipelined", 160, "PIPELINED_BLOCKS_F32")):
        assert fa.key_block(variant, dp, 128) == 128 and 128 not in getattr(fa, table)[dp]
        assert fa.kernel_entry(variant, dp, torch.bfloat16, 128) == (
            "flash_variants", f"pbe_flash_{variant}_bf16")
        assert fa.kernel_entry(variant, dp, f32, 128) == (
            "flash_variants_anyd", f"pbe_flash_{variant}_anyd_f32")
        x = torch.randn(1, 64, 1, dp)
        kw = {"block_k" if variant == "resident" else "block_c": 128}
        assert torch.equal(fa.flash_forward(x, x, x, variant=variant, **kw),
                           fa.flash_attention_plain(x, x, x))
        y = x.bfloat16()
        assert fa.flash_forward(y, y, y, variant=variant, **kw).dtype == torch.bfloat16
    # the benchmark's VAE shape at fp32: K4's 64-key chunks and K3's cluster
    vae = (2, 4096, 1, 512)
    assert fa.flash_fwd_pipelined.plan(vae, 64, dtype=f32) == [64]
    assert fa.flash_fwd_resident.plan(vae, dtype=f32) == [32, 1]


# the benchmark's shapes at fp32 (a key block of 64 below d = 160, else 32)
# and one q tile or just past it: below d = 512, 2 blocks a cluster wherever
# a head has 2 q tiles of RESIDENT_BLOCK_Q_F32, whatever the bf16 plan picks
# (4 at ds1); at 512, 1
@pytest.mark.parametrize("shape,plan", [
    ((2, 4096, 8, 40), [64, 2]), ((2, 1024, 8, 80), [64, 2]), ((2, 256, 8, 160), [32, 2]),
    ((2, 4096, 1, 512), [32, 1]), ((1, 128, 2, 40), [64, 1]), ((1, 129, 2, 40), [64, 2]),
    ((1, 128, 2, 80), [64, 1]), ((2, 32, 8, 160), [32, 1]), ((1, 77, 1, 512), [32, 1])],
    ids=["ds1", "ds2", "ds4", "vae", "one_tile_d40", "two_tiles_d40", "one_tile_d80",
         "one_tile_d160", "two_tiles_d512"])
def test_fp32_cluster_plan_reads_the_fp32_q_tile(shape, plan):
    assert fa.flash_fwd_resident.plan(shape, dtype=torch.float32) == plan
    assert fa.resident_cluster(shape, dtype=torch.float32) == plan[1]


def test_fp32_cluster_plan_takes_an_explicit_size_and_block():
    """An explicit cluster size is taken as it is; the q tile follows the
    key block (64 rows at block_k 128 from d <= 48)."""
    f32 = torch.float32
    assert fa.flash_fwd_resident.plan((2, 4096, 8, 40), cluster=4, dtype=f32) == [64, 4]
    assert fa.resident_cluster((1, 100, 1, 40), dtype=f32, block=128) == 2
    assert fa.resident_cluster((1, 100, 1, 40), dtype=f32, block=64) == 1
    with pytest.raises(ValueError, match="a cluster of 3 blocks"):
        fa.resident_cluster((2, 4096, 8, 40), 3, dtype=f32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_the_operands_dtype_picks_the_block_table_before_the_plan(dtype, monkeypatch):
    """The resident kernel's call checks its operands first and plans by
    their dtype: a 128-key block at d = 80 launches the tuned kernel for
    bf16 and the any-head-dim one (clusters of 1) for fp32, whose table
    lacks it."""
    calls = []
    monkeypatch.setattr(fa, "_check_operands", lambda *a, **kw: calls.append("check") or dtype)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=fa.SMS))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    kern = fa.FlashForward("resident")
    monkeypatch.setattr(kern, "_launch",
                        lambda dt, shape, *args, block=None: calls.append(
                            ("launch", dt, args[-3:-1], block)))
    x = torch.zeros(1, 64, 1, 80)
    kern(x, x, x, block=128)
    assert calls == ["check", ("launch", dtype, (128, 1), 128)]
    lib = "flash_variants_anyd" if dtype == torch.float32 else "flash_variants"
    assert kern.entry(dtype, 80, 128)[0] == lib


@pytest.mark.parametrize("precision,dtype,tf32_off", [("full", torch.float32, True),
                                                       ("autocast", torch.bfloat16, False)])
def test_precision_full_runs_fp32_on_the_card_with_tf32_off(monkeypatch, capsys, precision,
                                                           dtype, tf32_off):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert inference.device_and_dtype("cuda", precision) == ("cuda", dtype)
    assert torch.backends.cuda.matmul.allow_tf32 is not tf32_off
    assert torch.backends.cudnn.allow_tf32 is not tf32_off
    assert ("TF32 off" in capsys.readouterr().out) is tf32_off



@pytest.fixture
def _few_threads():
    """Six test workers share the CPU: two intra-op threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _pv_tf32(o, p, vh, k0, terms: int):
    """o + p V[k0:] as the kernels' k8 steps of mma.sync: operands split as
    hi = to_tf32(x), lo = x - hi (terms 3: lo hi + hi lo + hi hi; terms 1:
    hi hi), each kChain = 8 steps summed into a zeroed partial that then
    joins o in fp32."""
    for c0 in range(0, p.shape[-1], 64):
        part = torch.zeros_like(o)
        for ks in range(c0, min(c0 + 64, p.shape[-1]), 8):
            a, b = p[..., ks:ks + 8], vh[..., k0 + ks:k0 + ks + 8, :]
            ah, bh = tf32(a), tf32(b)
            if terms == 3:
                part = mma_k8(part, top19(a - ah), bh)
                part = mma_k8(part, ah, top19(b - bh))
            part = mma_k8(part, ah, bh)
        o = o + part
    return o


def _flash_tf32(q, k, v, terms: int, bk: int = 64, variant: str = "resident"):
    """The fp32 kernels' arithmetic in torch, S in fp32 and P V by _pv_tf32
    over key tiles of bk keys. "resident" (the forward's and K3's order):
    the online softmax, m, l and O rescaled once a tile, then the tile's P
    V. "pipelined" (K4's): pass 1 the final row max over every tile, pass 2
    P = exp2(S - m) with no rescale, l and P V summed tile by tile."""
    s2 = fa._heads(fa.prescale(q)) @ fa._heads(k).transpose(-1, -2)
    vh = fa._heads(v)
    m = torch.full(s2.shape[:-1] + (1,), -torch.inf)
    if variant == "pipelined":
        for k0 in range(0, s2.shape[-1], bk):
            m = torch.maximum(m, s2[..., k0:k0 + bk].amax(-1, keepdim=True))
    l, o = torch.zeros_like(m), torch.zeros(s2.shape[:-1] + vh.shape[-1:])
    for k0 in range(0, s2.shape[-1], bk):
        if variant == "pipelined":
            p = torch.exp2(s2[..., k0:k0 + bk] - m)
            l = l + p.sum(-1, keepdim=True)
        else:
            mn = torch.maximum(m, s2[..., k0:k0 + bk].amax(-1, keepdim=True))
            alpha, p = torch.exp2(m - mn), torch.exp2(s2[..., k0:k0 + bk] - mn)
            l, o, m = l * alpha + p.sum(-1, keepdim=True), o * alpha, mn
        o = _pv_tf32(o, p, vh, k0, terms)
    return (o / l).permute(0, 2, 1, 3)


# the fp32 forward at its key tile of 64 (K1/K2), and K3 and K4 at key
# blocks of 32 and 128 over N = 160 (a ragged last tile)
PV_CASES = [pytest.param((1, 256, 2, 40), 64, "resident", id="d40"),
            pytest.param((1, 128, 1, 160), 64, "resident", id="d160"),
            pytest.param((1, 128, 1, 512), 64, "resident", id="d512"),
            pytest.param((1, 160, 2, 40), 32, "resident", id="k3_b32"),
            pytest.param((1, 160, 2, 40), 128, "resident", id="k3_b128"),
            pytest.param((1, 160, 2, 40), 32, "pipelined", id="k4_b32"),
            pytest.param((1, 160, 2, 40), 128, "pipelined", id="k4_b128")]


@pytest.mark.parametrize("kind", ["randn", "peaked", "rising"])
@pytest.mark.parametrize("shape,bk,variant", PV_CASES)
def test_3xtf32_pv_meets_the_fp32_tolerances_where_1xtf32_fails(shape, bk, variant, kind,
                                                                 _few_threads):
    """The fp32 kernels' P V as 3xTF32 tensor-core products, in the
    forward's, K3's and K4's order, lands within phase 20's F32_MAX_REL /
    F32_L2_REL of flash_attention_plain; the same products at 1xTF32 do
    not, which is why P V takes three of them."""
    q, k, v = stress_inputs(kind, shape)
    want = fa.flash_attention_plain(q, k, v)
    max3, l2_3 = rel_errors(_flash_tf32(q, k, v, 3, bk, variant), want)
    max1, l2_1 = rel_errors(_flash_tf32(q, k, v, 1, bk, variant), want)
    assert max3 <= chip_smoke.F32_MAX_REL and l2_3 <= chip_smoke.F32_L2_REL, (max3, l2_3)
    assert max1 > chip_smoke.F32_MAX_REL or l2_1 > chip_smoke.F32_L2_REL, (max1, l2_1)


@pytest.mark.parametrize("variant,bk", [("resident", 128), ("pipelined", 32)])
def test_3xtf32_variants_match_the_pallas_kernels_at_fp32(variant, bk, _few_threads):
    """K3's and K4's 3xTF32 order against the JAX package's resident and
    pipelined Pallas kernels at fp32 (interpret mode), with the key block
    of the emulation, at chip_smoke.py's fp32 tolerances; the LSE too."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from pbe_tpu.ops import flash_attention as jfa

    q, k, v = stress_inputs("randn", (1, 256, 1, 40), seed=5)
    jx = lambda x: jnp.asarray(x[:, :, 0].numpy())
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = jfa._flash_fwd_bhnd(
            jx(q), jx(k), jx(v), block_q=128, block_k=bk if variant == "resident" else 128,
            return_stats=True, variant=variant,
            **({"block_c": bk} if variant == "pipelined" else {}))
    want = torch.from_numpy(np.array(want))[:, :, None, :]
    got = _flash_tf32(q, k, v, 3, bk, variant)
    err_max, err_l2 = rel_errors(got, want)
    assert err_max <= chip_smoke.F32_MAX_REL and err_l2 <= chip_smoke.F32_L2_REL, (err_max,
                                                                                  err_l2)
    _, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    want_lse = torch.from_numpy(np.array(want_lse))[..., 0]
    assert (lse - want_lse).abs().max() <= chip_smoke.F32_MAX_REL * want_lse.abs().max()


@pytest.mark.parametrize("shape,ms", [((2, 4096, 8, 40), 0.3210), ((4, 4096, 1, 512), 1.0272),
                                      ((2, 4096, 1, 512), 0.5136)],
                         ids=["edit_ds1", "train_vae", "bench_vae"])
def test_fp32_forward_bound_is_s_on_fma_beside_3xtf32_pv(shape, ms):
    """The bound at fp32 accuracy of the fp32 forward's rows and of phase
    11's fp32 K3 and K4 rows, which compute the same function: S (2 B H N^2
    d FLOP) on fp32 FMA binds, beside P V as three TF32 products; q, k, v
    read and O written once. (K4's algorithm computes S twice; the row keeps
    the function's bound and the log gives that floor.)"""
    b, n, h, d = shape
    by, got = chip_smoke.bound_3xtf32(4.0, b, n, h, d, 4.0 * b * n * h * d * 4)
    assert by == "fma" and round(got, 4) == ms


def test_variant_tiles_match_the_source_and_the_fp32_cluster_plan():
    """ops.flash_attention.variant_tile_f32 is the source's VarTile and
    WideVar choice, and K3's q tiles in RESIDENT_BLOCK_Q_F32 are its 16 MT
    RG rows: 128 at the benchmark's ds1 and ds2 (block 64), 32 at ds4, 64
    at 512 and at block 128."""
    src = (CSRC / "flash_fp32.cu").read_text()
    assert ("  static constexpr bool WIDE_MT = (!RES || DP == 80) && DP <= 80 && BK < 128;\n"
            "  static constexpr int MT = WIDE_MT ? 2 : 1;\n"
            "  static constexpr int SPLIT = WIDE_MT ? 2 : DP <= 48 ? (BK == 128 ? 2 : 1) : "
            "DP == 80 ? 2 : 4;\n  static constexpr int RG = 8 / SPLIT;") in src
    assert src.count("using T = WideVar<2, 2, 4, BK>;") == 2
    q_tile = fa.RESIDENT_BLOCK_Q_F32
    assert (q_tile[48][64], q_tile[80][64], q_tile[160][32], q_tile[512][32],
            q_tile[48][128]) == (128, 128, 32, 64, 64)
    assert fa.variant_tile_f32(48, 64, False) == (2, 4, 2)  # K4 pairs 32-row warps


def test_ptxas_report_names_every_fp32_variant_instantiation():
    """ptxas_report names each resident and pipelined fp32 kernel that the
    launchers dispatch to (<DP, D, MT, RG, SPLIT, BK>: the resident one at D
    = DP and DP - 8 below 512, the pipelined one at D = DP with the head dim
    at run time), for every key block of the fp32 tables."""
    kernels = []
    for name, table in (("flash_resident_f32_kernel", fa.RESIDENT_BLOCKS_F32),
                        ("flash_pipelined_f32_kernel", fa.PIPELINED_BLOCKS_F32)):
        for dp, blocks in table.items():
            for bk in blocks:
                resident = name.startswith("flash_resident")
                tile = fa.variant_tile_f32(dp, bk, resident)
                for d in ((dp, dp - 8) if resident and dp < 512 else (dp,)):
                    kernels.append((name, [dp, d, *tile, bk]))
    assert len(kernels) == (2 * sum(map(len, fa.RESIDENT_BLOCKS_F32.values())) - 1
                            + sum(map(len, fa.PIPELINED_BLOCKS_F32.values())))
    log, want = [], []
    for name, nums in kernels:
        mangled = "".join(f"Li{x}E" for x in nums)
        log += [f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{len(name)}{name}"
                f"I{mangled}EEvNS_4ArgsE' for 'sm_90a'",
                "ptxas info    : Function properties for x",
                "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                "ptxas info    : Used 200 registers, used 1 barriers"]
        want.append(f"  {name}<{', '.join(map(str, nums))}>: 0 bytes stack frame")
    report = ptxas_report("\n".join(log)).splitlines()
    assert [line[:len(w)] for line, w in zip(report, want)] == want and len(report) == len(want)


def test_ptxas_report_names_every_fp32_forward_instantiation():
    """sweep_flash_tiles.ptxas_report (chip_smoke.py phase 1's register and
    spill lines) names each forward kernel that pbe_flash_fwd_f32
    dispatches to, with its template arguments, from a -Xptxas -v log: at
    d <= 160 launch_fwd<DP, ...> instantiates the head dims DP and DP - 8."""
    src = (CSRC / "flash_fp32.cu").read_text()
    entry = src[src.index('extern "C" int pbe_flash_fwd_f32'):]
    entry = entry[:entry.index("\n}\n")]
    launches = re.findall(r"launch_fwd(_wide)?<([\d, ]+)>", entry)
    assert {int(args.split(",")[0]) for wide, args in launches if not wide} == {16, 32, 48, 80,
                                                                               160}
    assert any(wide for wide, _ in launches)
    kernels = []
    for wide, args in launches:
        nums = [int(x) for x in args.split(",")]
        if wide:
            kernels.append(("flash_fwd_wide_f32_kernel", nums))
        else:
            kernels += [("flash_fwd_f32_kernel", [nums[0], d, *nums[1:]])
                        for d in (nums[0], nums[0] - 8)]
    log, want = [], []
    for name, nums in kernels:
        mangled = "".join(f"Li{x}E" for x in nums)
        log += [f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1{len(name)}{name}"
                f"I{mangled}EEvNS_4ArgsE' for 'sm_90a'",
                "ptxas info    : Function properties for x",
                "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                "ptxas info    : Used 200 registers, used 1 barriers"]
        want.append(f"  {name}<{', '.join(map(str, nums))}>: 0 bytes stack frame")
    report = ptxas_report("\n".join(log)).splitlines()
    assert [line[:len(w)] for line, w in zip(report, want)] == want and len(report) == len(want)
