"""The resident and pipelined forward kernels (K3, K4) at every head dim
from 1 to 1024: csrc/flash_variants_anyd.cu serves every (head dim, key
block) pair that the tuned kernels' tables lack. Here, on the CPU:
flash_forward(variant=...) against the JAX package's Pallas K3 and K4
(interpret mode, as tests/test_torch_flash_variants.py runs them) at head
dims outside the tuned table; the rule that names the kernel; the
wrappers' routes and counts (a stand-in library records the entry each
launch loads); the refusals that remain; the C entries' argument lists; the
ptxas report's names; the fp32 body's 3xTF32 P V, emulated in its order
and held to phase 29's fp32 tolerances, which 1xTF32 misses. The CUDA
kernels themselves are held against the plain version on the card by
chip_smoke.py phase 30."""
import itertools
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pbe_tpu.ops import flash_attention as jfa

import chip_smoke
from pbe_tpu_torch.ops import cuda_build
from pbe_tpu_torch.ops import flash_attention as tfa
from pbe_tpu_torch.scripts.sweep_flash_tiles import ptxas_report

from _torch_port import rel_errors, stress_inputs, tf32_steps

CSRC = Path(tfa.__file__).resolve().parent.parent / "csrc"
WRAPPERS = {"resident": tfa.flash_fwd_resident, "pipelined": tfa.flash_fwd_pipelined}
BLOCK_ARG = {"resident": "block_k", "pipelined": "block_c"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Six test workers share the CPU: two intra-op threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _qkv(shape, seed):
    g = np.random.default_rng(seed)
    return [g.standard_normal(shape).astype(np.float32) for _ in range(3)]


# head dims the tuned kernels lack (36 pads to 48 but is no multiple of 8),
# at one and at two q blocks of the Pallas kernels' 128 rows
@pytest.mark.parametrize("block", [32, 64])
@pytest.mark.parametrize("d, n", [(28, 256), (36, 256), (64, 128), (100, 256), (256, 128)])
@pytest.mark.parametrize("variant", ["resident", "pipelined"])
def test_flash_forward_matches_the_pallas_kernel_at_any_head_dim(variant, d, n, block):
    """fp32, the bounds of tests/test_torch_flash_variants.py: O within
    2e-5, the log2-domain LSE within 1e-4."""
    q, k, v = _qkv((2, n, d), seed=d + block)
    kw = ({"block_k": block} if variant == "resident" else {"block_k": 128, "block_c": block})
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = jfa._flash_fwd_bhnd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             block_q=128, return_stats=True, variant=variant,
                                             **kw)
    as_bnhd = lambda a: torch.from_numpy(a)[:, :, None, :]
    got, got_lse = tfa.flash_forward(as_bnhd(q), as_bnhd(k), as_bnhd(v), variant=variant,
                                     return_lse=True, **{BLOCK_ARG[variant]: block})
    np.testing.assert_allclose(got[:, :, 0].numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0], atol=1e-4)
    assert tfa.kernel_entry(variant, d, torch.float32, block)[0] == "flash_variants_anyd"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_kernel_entry_names_the_tuned_variant_where_its_table_has_the_block(dtype):
    """At every head dim 1..1024 and key block of KEY_BLOCKS: the tuned
    kernel where it instantiates the head dim and its table the block,
    else csrc/flash_variants_anyd.cu's."""
    sfx = "bf16" if dtype == torch.bfloat16 else "f32"
    tuned_lib = "flash_fp32" if sfx == "f32" else "flash_variants"
    for variant in tfa.VARIANT_KINDS:
        table = tfa.block_table(variant, dtype)
        for d in range(1, tfa.ANYD_MAX_HEAD_DIM + 1):
            for block in tfa.KEY_BLOCKS:
                tuned = tfa.tuned_head_dim(d) and block in table[(d + 15) // 16 * 16]
                want = ((tuned_lib, f"pbe_flash_{variant}_{sfx}") if tuned else
                        ("flash_variants_anyd", f"pbe_flash_{variant}_anyd_{sfx}"))
                assert tfa.kernel_entry(variant, d, dtype, block) == want, (variant, d, block)
            assert tfa.kernel_entry(variant, d, dtype) == tfa.kernel_entry(
                variant, d, dtype, tfa.key_block(variant, d))
    anyd = lambda variant, d, block: tfa.kernel_entry(variant, d, dtype, block)[0]
    # d = 36 pads to 48 but no tuned kernel reads it; K3's tables lack
    # block 128 at d = 160 and block 64 at d = 512, at either dtype
    assert {anyd(v, 36, b) for v in tfa.VARIANT_KINDS for b in tfa.KEY_BLOCKS} == {
        "flash_variants_anyd"}
    assert anyd("resident", 160, 128) == anyd("resident", 512, 64) == "flash_variants_anyd"
    assert anyd("resident", 40, 64) == anyd("pipelined", 512, 64) == tuned_lib
    with pytest.raises(ValueError, match="takes no key block"):
        tfa.kernel_entry("fwd", 64, dtype, 64)


def test_every_head_dim_and_block_runs_on_the_cpu():
    """flash_forward(variant=...) at every d in 1..1024 and block in
    KEY_BLOCKS returns the plain version's result on CPU tensors, and
    plans the launch a CUDA tensor would take (the resident kernel at a
    cluster of 1 wherever the any-head-dim kernel runs)."""
    for d in range(1, tfa.ANYD_MAX_HEAD_DIM + 1):
        x = torch.from_numpy(_qkv((1, 3, 1, d), seed=d)[0])
        want = tfa.flash_attention_plain(x, x, x)
        for variant, kern in WRAPPERS.items():
            for block in tfa.KEY_BLOCKS:
                got = tfa.flash_forward(x, x, x, variant=variant, **{BLOCK_ARG[variant]: block})
                assert torch.equal(got, want), (variant, d, block)
                for dtype in tfa.KERNEL_DTYPES:
                    plan = kern.plan((1, 77, 2, d), block, dtype=dtype)
                    assert plan[0] == block
                    if variant == "resident" and not tfa.tuned_variant(variant, d, block, dtype):
                        assert plan == [block, 1]


def test_the_remaining_refusals():
    """A head dim outside 1..1024, a key block outside KEY_BLOCKS and a
    cluster past 1 where the any-head-dim kernel runs, on either device."""
    for d in (0, tfa.ANYD_MAX_HEAD_DIM + 1):
        x = torch.zeros(1, 8, 1, d)
        for variant in WRAPPERS:
            with pytest.raises(ValueError, match="the flash kernels take 1 to 1024"):
                tfa.flash_forward(x, x, x, variant=variant)
    x = torch.zeros(1, 8, 1, 64)
    for variant in WRAPPERS:
        with pytest.raises(ValueError, match="key block 256 is not instantiated"):
            tfa.flash_forward(x, x, x, variant=variant, **{BLOCK_ARG[variant]: 256})
    for d, block in ((64, None), (36, 32), (160, 128), (512, 64)):
        with pytest.raises(ValueError, match="clusters of 1"):
            tfa.flash_fwd_resident.plan((2, 4096, 8, d), block, cluster=2)
        with pytest.raises(ValueError, match="clusters of 1"):
            tfa.resident_cluster((2, 4096, 8, d), 4, block=block)
        assert tfa.resident_cluster((2, 4096, 8, d), 1, block=block) == 1
    # the tuned kernel at d = 40 keeps its clusters
    assert tfa.flash_fwd_resident.plan((2, 4096, 8, 40), 64, cluster=2) == [64, 2]


@pytest.mark.parametrize("variant", ["resident", "pipelined"])
def test_a_call_loads_the_entry_kernel_entry_names_and_counts_it(variant, monkeypatch):
    """Through the wrapper's call (CPU tensors standing in for CUDA ones, a
    stand-in library recording each lookup and each launch's key block and
    cluster): the any-head-dim entry at d = 36, at d = 160 with block 128
    (bf16 resident; both fp32 tables lack that block), the tuned one at d =
    40; counted in all, by shape, by dtype and by kernel."""
    loaded, blocks = [], []

    class Lib:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, symbol):
            loaded.append((self.name, symbol))
            return lambda *args: blocks.append(tuple(args[11:-1])) or 0

    monkeypatch.setattr(cuda_build, "load", Lib)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=tfa.SMS))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: SimpleNamespace(data_ptr=lambda: 0))
    kern = tfa.FlashForward(variant)
    calls = [(torch.bfloat16, 36, None), (torch.float32, 36, 128), (torch.bfloat16, 40, None),
             (torch.bfloat16, 160, 128), (torch.float32, 160, 128), (torch.bfloat16, 40, None)]
    for dtype, d, block in calls:
        x = torch.zeros(1, 64, 2, d, dtype=dtype)
        kern(x, x, x, block=block)
    want = [tfa.kernel_entry(variant, d, dtype, block) for dtype, d, block in calls]
    assert loaded == list(dict.fromkeys(want))  # each entry loaded at its first launch
    anyd = {(dtype, d, block) for dtype, d, block in calls
            if not tfa.tuned_variant(variant, d, tfa.key_block(variant, d, block), dtype)}
    assert {(torch.bfloat16, 36, None), (torch.float32, 36, 128)} <= anyd
    assert (torch.float32, 160, 128) in anyd
    assert ((torch.bfloat16, 160, 128) in anyd) == (variant == "resident")
    extra = [[tfa.key_block(variant, d, block)] + [1] * (variant == "resident")
             for _, d, block in calls]
    assert [list(b) for b in blocks] == extra
    assert kern.launches == len(calls)
    assert kern.launches_by_kernel == {f"flash_{variant}_anyd": len(anyd),
                                       f"flash_{variant}": len(calls) - len(anyd)}
    assert kern.launches_by_dtype == {"bfloat16": 4, "float32": 2}
    assert kern.launches_by_shape[(1, 64, 2, 40)] == 2
    kern.reset()
    assert (kern.launches, kern.launches_by_kernel) == (0, {})


def _entry(path, symbol):
    src = (CSRC / path).read_text()
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\) \{(.*?)\n\}", src, re.S)
    assert m, (path, symbol)
    return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")], m.group(2)


def test_source_defines_every_entry_with_its_twins_arguments():
    """csrc/flash_variants_anyd.cu exports the four symbols the wrappers
    load, each with its tuned twin's parameter list (the wrappers share
    argtypes), each running its own kernel: K3 and K4 by the schedule
    argument of run_variant, on the any-head-dim forward's bodies with the
    key block a template argument (bf16 on mma.sync, fp32 on 3xTF32 with S
    on FMA), whose kernels are K3 at block 64; none relaunches the
    any-head-dim forward, and no SIMT body is left. The library is keyed on
    flash_anyd.cu too, whose device code it includes."""
    src = (CSRC / "flash_variants_anyd.cu").read_text()
    for variant, two_pass in (("resident", "false"), ("pipelined", "true")):
        twin = _entry("flash_variants.cu", f"pbe_flash_{variant}_bf16")[0]
        for sfx, dtype in (("bf16", "bf16"), ("f32", "float")):
            params, body = _entry("flash_variants_anyd.cu", f"pbe_flash_{variant}_anyd_{sfx}")
            assert params == twin == _entry("flash_fp32.cu", f"pbe_flash_{variant}_f32")[0]
            assert f"run_variant<{dtype}, {two_pass}>(" in body
            assert ("cluster != 1" in body) == (variant == "resident")
        assert f"flash_{variant}_anyd_mma(const Args<bf16> a) {{\n  fwd_mma<WARPS, CS, BK, {two_pass}>(a);" in src
        assert (f"flash_{variant}_anyd_tf32(const Args<float> a) {{\n"
                f"  fwd_tf32<WARPS, CS, BK, QRES, {two_pass}>(a);") in src
    for kern in ("flash_resident_anyd_mma<", "flash_pipelined_anyd_mma<",
                 "flash_resident_anyd_tf32<", "flash_pipelined_anyd_tf32<"):
        assert f"kern = {kern}" in src
    assert "mma_bf16(" not in src and "chunk_scores<" not in src and "fwd_mma_plan<BK>(" in src
    assert "scores_fma<" not in src and "fwd_tf32_plan<BK, TWO_PASS>(" in src and "fwd_simt" not in src
    assert "launch_fwd_bf16" not in src and "pbe_flash_fwd_anyd" not in src
    assert src.index("#define PBE_ANYD_DEVICE_ONLY") < src.index('#include "flash_anyd.cu"')
    anyd = (CSRC / "flash_anyd.cu").read_text()
    assert anyd.count("#ifndef PBE_ANYD_DEVICE_ONLY") == 2
    cut = anyd.index("#ifndef PBE_ANYD_DEVICE_ONLY")
    assert cut < anyd.index("launch_fwd_bf16(") and "fwd_mma_plan<64>(" in anyd[cut:]
    assert "fwd_tf32_plan<64, false>(" in anyd[cut:]
    for body in ("void fwd_mma(", "void fwd_tf32(", "cudaError_t fwd_mma_plan(",
                 "cudaError_t fwd_tf32_plan(", "cudaError_t launch_fwd_tf32_tiles("):
        assert anyd.index(body) < cut
    assert "flash_fwd_anyd_mma(const Args<bf16> a) {\n  fwd_mma<WARPS, CS, 64, false>(a);" in anyd
    assert ("flash_fwd_anyd_tf32(const Args<float> a) {\n"
            "  fwd_tf32<WARPS, CS, 64, QRES, false>(a);") in anyd
    assert "fwd_simt" not in anyd and "FwdSimt" not in anyd
    fwd = anyd[anyd.index("void fwd_mma("):anyd.index("void __launch_bounds__(32 * WARPS, 1) flash_fwd_anyd_mma(")]
    assert "chunk_scores<" in fwd and "softmax_step<" in fwd and "final_p<" in fwd
    fwd = anyd[anyd.index("void fwd_tf32("):anyd.index("void __launch_bounds__(32 * WARPS, 1) flash_fwd_anyd_tf32(")]
    assert "scores_pair_fma<" in fwd and "pair_to_c<" in fwd and "pv_panel_tf32<" in fwd
    assert "softmax_steps_f32<" in fwd


def test_library_key_covers_the_included_source(tmp_path, monkeypatch):
    """An edit of csrc/flash_anyd.cu rebuilds flash_variants_anyd.cu's
    library, which includes it; an edit of flash_variants_anyd.cu leaves
    flash_anyd.cu's library as it is."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", csrc / "build")
    names = ("flash_anyd", "flash_variants_anyd")
    before = {n: cuda_build.library_path(n) for n in names}
    (csrc / "flash_anyd.cu").write_text((csrc / "flash_anyd.cu").read_text() + "\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    (csrc / "flash_variants_anyd.cu").write_text(
        (csrc / "flash_variants_anyd.cu").read_text() + "\n// edited\n")
    assert cuda_build.library_path("flash_anyd") == after["flash_anyd"]
    assert cuda_build.library_path("flash_variants_anyd") != after["flash_variants_anyd"]


def test_ptxas_report_names_the_new_kernels_by_operand_type():
    """chip_smoke.py phase 30's build log names each kernel: the mma.sync
    ones with their warps, slice and key block, the 3xTF32 ones with their
    warps, slice, key block and q2 residency, and a SIMT one (gone from the
    source; phase 30 refuses any left) with its operand type and key
    block."""
    def compiled(mangled):
        return [f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'",
                "ptxas info    : Function properties for x",
                "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                "ptxas info    : Used 200 registers, used 1 barriers"]

    log, want = [], []
    for name in ("flash_resident_anyd", "flash_pipelined_anyd"):
        for bk in tfa.KEY_BLOCKS:
            log += compiled(f"_ZN12_GLOBAL__N_1{len(name)}{name}IfLi{bk}EEEvNS_4ArgsIT_EE")
            want.append(f"  {name}<fp32, {bk}>: 0 bytes stack frame")
    for name in ("flash_resident_anyd_mma", "flash_pipelined_anyd_mma"):
        for args in ((8, 256, 32), (4, 128, 128)):
            targs = "".join(f"Li{a}E" for a in args)
            log += compiled(f"_ZN12_GLOBAL__N_1{len(name)}{name}I{targs}EEvNS_4ArgsI13"
                            f"__nv_bfloat16EE")
            want.append(f"  {name}<{', '.join(map(str, args))}>: 0 bytes stack frame")
    for name in ("flash_resident_anyd_tf32", "flash_pipelined_anyd_tf32"):
        for args in ((8, 256, 32, 1), (4, 128, 128, 0)):
            targs = "".join(f"Li{a}E" for a in args[:3]) + f"Lb{args[3]}E"
            log += compiled(f"_ZN12_GLOBAL__N_1{len(name)}{name}I{targs}EEvNS_4ArgsIfEE")
            want.append(f"  {name}<{', '.join(map(str, args))}>: 0 bytes stack frame")
    report = ptxas_report("\n".join(log)).splitlines()
    assert [line[:len(w)] for line, w in zip(report, want)] == want and len(report) == len(want)


def _fwd_tf32(q, k, v, block: int, two_pass: bool, terms: int):
    """csrc/flash_anyd.cu's fp32 forward body (fwd_tf32: the any-head-dim
    forward, K3 and K4) in torch -> (O, LSE) as flash_attention_plain gives
    them: S in fp32 (the plain version's S, as the kernel's fmaf chain is
    cuBLAS's order), key tiles of ``block``; K3 (two_pass False) one
    online-softmax step a tile, O and l rescaled by exp2(m_old - m_new)
    before the tile's P V; K4 against the final row max, never rescaled;
    P V in 3xTF32 (terms 3; 1: hi hi alone), one zeroed partial a run of at
    most 64 keys (8 k8 steps) of a tile, joined to O in fp32."""
    b, n, h, d = q.shape
    s2 = tfa._heads(tfa.prescale(q)) @ tfa._heads(k).transpose(-1, -2)
    vh = tfa._heads(v)
    o, l = torch.zeros(b, h, n, d), torch.zeros(b, h, n, 1)
    m = s2.amax(-1, keepdim=True) if two_pass else torch.full((b, h, n, 1), -torch.inf)
    for t0 in range(0, n, block):
        s = s2[..., t0:t0 + block]
        if not two_pass:
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - mx)
            m, o, l = mx, o * alpha, l * alpha
        p = torch.exp2(s - m)
        l = l + p.sum(-1, keepdim=True)
        for k0 in range(0, block, 64):
            o = tf32_steps(o, p, vh[..., t0:t0 + block, :], k0, k0 + 64, terms, False)
    out = (o / l).permute(0, 2, 1, 3)
    return out, (m + torch.log2(l)).reshape(b * h, n)


@pytest.mark.parametrize("block", tfa.KEY_BLOCKS)
@pytest.mark.parametrize("kind", ["randn", "peaked", "rising"])
@pytest.mark.parametrize("d", chip_smoke.ANYD_STRESS_DIMS)
def test_3xtf32_forward_meets_the_fp32_tolerances_where_1xtf32_fails(d, kind, block):
    """The fp32 any-head-dim forward, K3 and K4 (one body, fwd_tf32): P V
    as 3xTF32 tensor-core steps in the kernel's order, with K3's rescale and
    K4's final max, lands within phase 29's F32_MAX_REL / F32_L2_REL of
    flash_attention_plain on its randn, peaked and rising-max inputs at N =
    200 (a ragged last key tile) at every key block, O and the LSE (the
    LSE to F32_MAX_REL of its largest magnitude, compare_flash's measure);
    at 1xTF32 O does not. This is why P V runs in 3xTF32."""
    q, k, v = stress_inputs(kind, (1, 200, 2, d), seed=d)
    want, want_lse = tfa.flash_attention_plain(q, k, v, return_lse=True)
    lse_tol = chip_smoke.F32_MAX_REL * want_lse.abs().max().item()
    for two_pass, terms in itertools.product((False, True), (3, 1)):
        out, lse = _fwd_tf32(q, k, v, block, two_pass, terms)
        m, l2 = rel_errors(out, want)
        assert (lse - want_lse).abs().max().item() <= lse_tol, (two_pass, terms)
        inside = m <= chip_smoke.F32_MAX_REL and l2 <= chip_smoke.F32_L2_REL
        assert inside == (terms == 3), (two_pass, terms, m, l2)
