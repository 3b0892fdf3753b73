"""The flash kernels at any head dim: csrc/flash_anyd.cu's forward, dQ and
dK/dV kernels serve every head dim from 1 to 1024 that the tuned kernels
do not instantiate. Here, on the CPU: the dispatch that names the kernel
for a head dim and dtype, each kernel's layout rule, the wrappers' routes
and counts (a stand-in library records the entry each launch loads), and
the port's flash_attention at head dims outside the tuned table against
the JAX package's Pallas flash_attention (interpret mode, as
tests/test_flash_attention.py runs it), forward and gradients, alone and
inside a small vae_legacy.Model. The CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py phase 29; the fp32
dK/dV kernel's 3xTF32 products are emulated here in its order and held to
phase 29's fp32 tolerances, which 1xTF32 misses."""
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pbe_tpu.models import vae_legacy as jvl
from pbe_tpu.ops import flash_attention as jfa

import chip_smoke
from pbe_tpu_torch import convert
from pbe_tpu_torch.models import vae_legacy as tvl
from pbe_tpu_torch.ops import cuda_build
from pbe_tpu_torch.ops import flash_attention as tfa

from _torch_port import rel_errors, stress_inputs, tf32_steps

CSRC = Path(tfa.__file__).resolve().parent.parent / "csrc"
DTYPES = [torch.bfloat16, torch.float32]
# the head dims the tuned kernels instantiate: a multiple of 8 padding to
# one of SUPPORTED_HEAD_DIMS
TUNED = {8, 16, 24, 32, 40, 48, 72, 80, 152, 160, 504, 512}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Six test workers share the CPU: two intra-op threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
def test_kernel_entry_names_the_tuned_kernel_at_its_head_dims_and_flash_anyd_elsewhere(dtype):
    sfx = "bf16" if dtype == torch.bfloat16 else "f32"
    tuned_lib = {"fwd": "flash_fwd", "bwd_dq": "flash_bwd", "bwd_dkv": "flash_bwd"}
    for kind in tfa.ANYD_KINDS:
        for d in range(1, tfa.ANYD_MAX_HEAD_DIM + 1):
            got = tfa.kernel_entry(kind, d, dtype)
            if d in TUNED:
                lib = "flash_fp32" if sfx == "f32" else tuned_lib[kind]
                assert got == (lib, f"pbe_flash_{kind}_{sfx}"), d
            else:
                assert got == ("flash_anyd", f"pbe_flash_{kind}_anyd_{sfx}"), d
            assert tfa.tuned_head_dim(d) == (d in TUNED)
        for d in (0, tfa.ANYD_MAX_HEAD_DIM + 1, 2048):
            with pytest.raises(ValueError, match="the flash kernels take 1 to 1024"):
                tfa.kernel_entry(kind, d, dtype)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tfa.kernel_entry("fwd", 64, torch.float16)
    with pytest.raises(ValueError, match="unknown flash pass"):
        tfa.kernel_entry("streamed", 64, dtype)
    # each wrapper launches what kernel_entry names, and takes its dtypes
    for wrapper, kind in ((tfa.flash_fwd, "fwd"), (tfa.flash_bwd_dq, "bwd_dq"),
                          (tfa.flash_bwd_dkv, "bwd_dkv")):
        for d in (28, 40, 256):
            assert wrapper.entry(dtype, d) == tfa.kernel_entry(kind, d, dtype)
        assert dtype in wrapper.dtypes and wrapper.kind == kind


def test_layout_rule_follows_the_kernel():
    """A packed q at d = 28 (rows of 3 x 28 elements, views at offsets 0,
    28, 56) is read in place by csrc/flash_anyd.cu and refused by the tuned
    kernels' rule at d = 40; a head-dim stride other than 1 is refused by
    both, and a head dim past 1024 by the any-dim rule."""
    q, k, v = torch.zeros(2, 10, 3, 2, 28).unbind(2)
    for x in (q, k, v):
        assert tfa.layout_error(x) is None
    permuted = torch.zeros(2, 10, 28, 2).permute(0, 1, 3, 2)
    assert "unit head-dim stride" in tfa.layout_error(permuted)
    # at d = 1 the head-dim stride is never stepped
    assert tfa.layout_error(torch.zeros(4).as_strided((1, 4, 1, 1), (4, 1, 1, 7))) is None
    assert "1 to 1024" in tfa.layout_error(torch.zeros(1, 2, 1, 1100))
    # at a tuned head dim the rule is the tuned kernels'
    x40 = torch.zeros(1, 10, 3, 1, 41)[..., :40].unbind(2)[1]
    assert "aligned to 8 elements" in tfa.layout_error(x40)


def test_kernel_cotangent_copies_only_what_the_kernel_cannot_read():
    do = torch.randn(1, 8, 3, 2, 28).unbind(2)[1]  # strided, base at 28 elements
    assert tfa.kernel_cotangent(do) is do
    expanded = torch.ones(()).expand(1, 8, 2, 28)
    handed = tfa.kernel_cotangent(expanded)
    assert handed is not expanded and tfa.layout_error(handed) is None
    do40 = torch.randn(1, 8, 3, 2, 41)[..., :40].unbind(2)[1]
    assert tfa.kernel_cotangent(do40) is not do40


@pytest.mark.parametrize("which", ["fwd", "dq", "dkv"])
def test_a_launch_loads_the_entry_its_head_dim_names_and_counts_it(which, monkeypatch):
    """The wrappers load csrc/flash_anyd.cu's entry at a head dim outside
    the tuned table and the tuned one inside it,
    and count every launch in all, by shape, by dtype and by kernel."""
    loaded = []

    class Lib:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, symbol):
            loaded.append((self.name, symbol))
            return lambda *args: 0

    monkeypatch.setattr(cuda_build, "load", Lib)
    kern = tfa.FlashForward() if which == "fwd" else tfa.FlashBackward(which)
    kind = "fwd" if which == "fwd" else f"bwd_{which}"
    shape = (2, 16, 1, 256)
    kern._launch(torch.float32, shape)
    kern._launch(torch.bfloat16, shape)
    kern._launch(torch.bfloat16, (2, 16, 1, 40))
    kern._launch(torch.bfloat16, (2, 16, 1, 40))
    assert loaded == [("flash_anyd", f"pbe_flash_{kind}_anyd_f32"),
                      ("flash_anyd", f"pbe_flash_{kind}_anyd_bf16"),
                      (tfa.kernel_entry(kind, 40, torch.bfloat16))]
    assert kern.launches == 4
    assert kern.launches_by_kernel == {f"flash_{kind}_anyd": 2, f"flash_{kind}": 2}
    assert kern.launches_by_shape == {shape: 2, (2, 16, 1, 40): 2}
    assert kern.launches_by_dtype == {"float32": 1, "bfloat16": 3}
    kern.reset()
    assert (kern.launches, kern.launches_by_kernel) == (0, {})


@pytest.mark.parametrize("which", ["fwd", "dq", "dkv"])
def test_the_call_checks_by_the_kernel_it_will_launch(which, monkeypatch):
    """A packed d = 28 view goes to the launch (any-dim rule) and is refused
    at d = 40, where the tuned kernel's rule holds, and an aligned d = 40
    goes to the tuned kernel; d = 1025 is refused for its head dim."""
    launched = []
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=tfa.SMS))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    # a stand-in device check: these CPU tensors pass for CUDA ones
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: torch.device("cuda", 0)))
    kern = tfa.FlashForward() if which == "fwd" else tfa.FlashBackward(which)
    monkeypatch.setattr(kern, "_launch", lambda dt, shape, *a, block=None: launched.append(
        (shape, kern.entry(dt, shape[3], block)[1])))
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: SimpleNamespace(data_ptr=lambda: 0))

    def call(x):
        if which == "fwd":
            return kern(x, x, x)
        b, n, h, _ = x.shape
        stats = SimpleNamespace(dtype=torch.float32, shape=(b * h, n), device=x.device,
                                is_contiguous=lambda: True, data_ptr=lambda: 0)
        return kern(x, x, x, x, stats, stats)

    kind = "fwd" if which == "fwd" else f"bwd_{which}"
    x28 = torch.zeros(1, 8, 3, 2, 28).unbind(2)[1]
    call(x28)
    x40 = torch.zeros(1, 8, 3, 2, 41)[..., :40].unbind(2)[1]
    with pytest.raises(ValueError, match="aligned to 8 elements"):
        call(x40)
    call(torch.zeros(1, 8, 2, 40))
    assert launched == [((1, 8, 2, 28), f"pbe_flash_{kind}_anyd_f32"),
                        ((1, 8, 2, 40), f"pbe_flash_{kind}_f32")]
    with pytest.raises(ValueError, match="1 to 1024"):
        call(torch.zeros(1, 2, 1, 1025))


def test_wrappers_refuse_cpu_tensors_at_any_head_dim():
    x = torch.zeros(1, 16, 1, 256)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(x, x, x)
    stats = torch.zeros(1, 16)
    for kern in (tfa.flash_bwd_dq, tfa.flash_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            kern(x, x, x, x, stats, stats)
    # the resident and pipelined kernels run d = 256 too (csrc/
    # flash_variants_anyd.cu): their wrappers refuse the CPU tensor, and
    # flash_forward runs the plain version on it
    for variant, kern in (("resident", tfa.flash_fwd_resident),
                          ("pipelined", tfa.flash_fwd_pipelined)):
        assert tfa.key_block(variant, 256) == 32
        with pytest.raises(ValueError, match="CUDA"):
            kern(x, x, x)
        q, k, v = (torch.from_numpy(a) for a in _inputs((1, 16, 1, 256), seed=3)[:3])
        got = tfa.flash_forward(q, k, v, variant=variant, return_lse=True)
        want = tfa.flash_attention_plain(q, k, v, return_lse=True)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_source_defines_every_anyd_entry_with_its_twins_arguments():
    """csrc/flash_anyd.cu exports the six symbols the wrappers load, each
    with its tuned twin's parameter list (the wrappers share argtypes); the
    bf16 entries launch the mma.sync kernels, the fp32 forward and dK/dV
    entries the 3xTF32 ones, the fp32 dQ its SIMT kernel; the SIMT dQ
    exists at fp32 only and no SIMT forward or dK/dV at all, and the 3xTF32
    and C-layout helpers come from the header flash_fp32.cu shares."""
    def entry(path, symbol):
        src = (CSRC / path).read_text()
        m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\) \{(.*?)\n\}", src, re.S)
        assert m, (path, symbol)
        return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")], m.group(2)

    body = {}
    for kind, twin in (("fwd", "flash_fwd"), ("bwd_dq", "flash_bwd"), ("bwd_dkv", "flash_bwd")):
        for sfx in ("bf16", "f32"):
            params, body[kind, sfx] = entry("flash_anyd.cu", f"pbe_flash_{kind}_anyd_{sfx}")
            assert params == entry(f"{twin}.cu", f"pbe_flash_{kind}_bf16")[0]
    for kind, sfx, run in (("fwd", "bf16", "launch_fwd_bf16(a"),
                           ("bwd_dq", "bf16", "launch_dq_bf16(a"),
                           ("bwd_dkv", "bf16", "launch_dkv_bf16(a"),
                           ("bwd_dkv", "f32", "launch_dkv_f32(a"),
                           ("fwd", "f32", "launch_fwd_f32(a"), ("bwd_dq", "f32", "run_dq<float>")):
        assert run in body[kind, sfx], (kind, sfx)
    src = (CSRC / "flash_anyd.cu").read_text()
    assert "run_fwd" not in src and "run_dq<bf16>" not in src and "run_dkv" not in src
    assert "flash_bwd_dkv_anyd(" not in src and "flash_fwd_anyd(" not in src
    assert "fwd_simt" not in src and "FwdSimt" not in src
    for kern in ("flash_fwd_anyd_mma<", "flash_bwd_dq_anyd_mma<", "flash_bwd_dkv_anyd_mma<",
                 "flash_fwd_anyd_tf32<", "flash_bwd_dkv_anyd_tf32<"):
        assert f"auto kern = {kern}" in src
    assert '#include "mma_sm90.cuh"' in src and "mma_bf16(" in src
    assert "mma_3xtf32(" in src
    fp32 = (CSRC / "flash_fp32.cu").read_text()
    assert '#include "mma_sm90.cuh"' in fp32
    for helper in ("to_tf32(float", "split_tf32(float", "mma_tf32(float", "mma_3xtf32(float",
                   "store_c(float", "load_c(float"):
        assert helper in (CSRC / "mma_sm90.cuh").read_text()
        assert helper not in src and helper not in fp32, helper
    assert cuda_build.library_path("flash_anyd").name.startswith("libflash_anyd-")


def _inputs(shape, seed):
    g = np.random.default_rng(seed)
    return [g.standard_normal(shape).astype(np.float32) for _ in range(4)]  # q k v G


def _assert_rel(got, want, rel):
    """max|got - want| <= rel * max|want|: fp32 on both sides, the two
    differ only in the order of their sums."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("d", [28, 64, 256, 1024])
def test_flash_attention_matches_pallas_at_head_dims_outside_the_tuned_table(d):
    """The forward and the gradients of sum(O * G) against JAX's
    flash_attention custom VJP (Pallas, interpret mode), fp32, with the
    bounds of tests/test_torch_flash_attention.py and
    tests/test_torch_flash_backward.py."""
    shape = (1, 64, 2, d)
    q, k, v, g = _inputs(shape, seed=d)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(jfa.flash_attention, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want_grads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=2e-5)
    (out * torch.from_numpy(g)).sum().backward()
    for leaf, w in zip(leaves, want_grads):
        _assert_rel(leaf.grad.numpy(), w, 1e-5)


def test_vae_legacy_model_with_flash_at_head_dim_64_matches_pallas():
    """A small DDPM Model whose attention runs at d = 64 (width 64 at the
    4^2 level and in the middle), attn_impl "flash" against JAX's "pallas"
    in interpret mode: the output and its gradient with respect to the
    input, each within 2e-4 of its RMS (the legacy models' bound)."""
    geo = dict(ch=32, out_ch=3, num_res_blocks=1, resolution=8, in_channels=3,
               ch_mult=(1, 2), attn_resolutions=(4,))
    jm = jvl.Model(**geo, attn_impl="pallas")
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    t = np.asarray([321.0], np.float32)
    g = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    # seeded values for every parameter (shapes from jax.eval_shape, so
    # nothing compiles): lecun-normal kernels, non-trivial scales and biases
    shapes = jax.eval_shape(lambda r: jm.init(r, jnp.asarray(x), jnp.asarray(t)),
                            jax.random.PRNGKey(0))

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            return rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return (1.0 if name.endswith("['scale']") else 0.0) + 0.1 * rng.standard_normal(s.shape)

    params = jax.tree_util.tree_map_with_path(lambda p, s: np.asarray(leaf(p, s), np.float32),
                                              shapes)
    def out_and_dx(xx, gg):  # one jitted program: op by op, interpret mode is slower
        out, vjp = jax.vjp(lambda y: jm.apply(params, y, jnp.asarray(t)), xx)
        return out, vjp(gg)[0]

    with pltpu.force_tpu_interpret_mode():
        want, want_dx = jax.jit(out_and_dx)(jnp.asarray(x), jnp.asarray(g))
    tm = tvl.Model(**geo, attn_impl="flash")
    tm.load_state_dict(convert.vae_legacy_state_dict_from_flax(params["params"]), strict=True)
    tm.eval()
    assert [b.attn_impl for b in tm.modules() if isinstance(b, tvl.AttnBlock)] == ["flash"] * 4
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    xt = nchw(x).requires_grad_()
    out = tm(xt, torch.from_numpy(t))
    (out * nchw(g)).sum().backward()

    def close(got, want):
        want = np.asarray(want, np.float64)
        rms = np.sqrt(np.mean(want ** 2))
        assert rms > 1e-3
        assert np.abs(np.asarray(got, np.float64) - want).max() <= 2e-4 * rms

    close(out.detach().numpy().transpose(0, 2, 3, 1), want)
    close(xt.grad.numpy().transpose(0, 2, 3, 1), want_dx)


def test_ptxas_report_names_the_anyd_kernels_by_operand_type():
    """chip_smoke.py's build log names each any-head-dim kernel with its
    operand type, as nvcc mangles the template's one argument."""
    from pbe_tpu_torch.scripts.sweep_flash_tiles import ptxas_report

    def compiled(mangled):
        return [f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'",
                "ptxas info    : Function properties for x",
                "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                "ptxas info    : Used 168 registers, used 1 barriers"]

    log, want = [], []
    # the SIMT kernels, at fp32 only (the forward's is gone: the report
    # must still name one, so that chip_smoke.py refuses it)
    for name in ("flash_fwd_anyd", "flash_bwd_dq_anyd"):
        log += compiled(f"_ZN12_GLOBAL__N_1{len(name)}{name}IfEEvNS_4ArgsIT_EE")
        want.append(f"  {name}<fp32>: 0 bytes stack frame")
    # the bf16 forward, dQ and dK/dV on mma.sync and the fp32 forward and
    # dK/dV on 3xTF32, by their tile arguments (the forward's q2 resident,
    # 1, or streamed, 0)
    for name, args, dtype in (("flash_fwd_anyd_mma", (4, 128), "I13__nv_bfloat16EE"),
                              ("flash_fwd_anyd_mma", (4, 256), "I13__nv_bfloat16EE"),
                              ("flash_bwd_dq_anyd_mma", (8, 256), "I13__nv_bfloat16EE"),
                              ("flash_bwd_dq_anyd_mma", (2, 256), "I13__nv_bfloat16EE"),
                              ("flash_bwd_dkv_anyd_mma", (4, 1), "I13__nv_bfloat16EE"),
                              ("flash_bwd_dkv_anyd_mma", (2, 2), "I13__nv_bfloat16EE"),
                              ("flash_fwd_anyd_tf32", (8, 256, 1), "IfEE"),
                              ("flash_fwd_anyd_tf32", (4, 128, 0), "IfEE"),
                              ("flash_bwd_dkv_anyd_tf32", (4, 128), "IfEE"),
                              ("flash_bwd_dkv_anyd_tf32", (1, 256), "IfEE")):
        targs = "".join(f"L{'b' if i == 2 and 'fwd' in name and 'tf32' in name else 'i'}{a}E"
                        for i, a in enumerate(args))
        log += compiled(f"_ZN12_GLOBAL__N_1{len(name)}{name}I{targs}EEvNS_4Args{dtype}")
        want.append(f"  {name}<{', '.join(map(str, args))}>: 0 bytes stack frame")
    report = ptxas_report("\n".join(log)).splitlines()
    assert [line[:len(w)] for line, w in zip(report, want)] == want and len(report) == len(want)


def _dkv_tf32(q, k, v, do, terms: int):
    """csrc/flash_anyd.cu's fp32 dK/dV (flash_bwd_dkv_anyd_tf32) in torch:
    S^T in fp32 (the plain version's S, as the kernel's fmaf chain is
    cuBLAS's order), then dP^T = V dO^T in chunks of KF = 64 head-dim
    columns, one pair of partials a chunk, and dV += P^T dO, dK += dS^T Q
    one partial a q tile of BQ = 32 queries."""
    b, n, h, d = q.shape
    out, lse = tfa.flash_attention_plain(q, k, v, return_lse=True)
    dd = tfa.rowsum_do_o(do, out).reshape(b, h, n, 1)
    s2 = tfa._heads(tfa.prescale(q)) @ tfa._heads(k).transpose(-1, -2)
    p = torch.exp2(s2 - lse.reshape(b, h, n, 1))
    dph = torch.zeros_like(p)
    doh, vt = tfa._heads(do), tfa._heads(v).transpose(-1, -2)
    for c0 in range(0, d, 64):
        dph = tf32_steps(dph, doh, vt, c0, c0 + 64, terms, True)
    ds = p * (dph - dd) * d ** -0.5
    dk, dv = torch.zeros(b, h, n, d), torch.zeros(b, h, n, d)
    pt, dst, qh = p.transpose(-1, -2), ds.transpose(-1, -2), tfa._heads(q)
    for q0 in range(0, n, 32):
        dv = tf32_steps(dv, pt, doh, q0, q0 + 32, terms, False)
        dk = tf32_steps(dk, dst, qh, q0, q0 + 32, terms, False)
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


@pytest.mark.parametrize("kind", ["randn", "peaked", "rising"])
@pytest.mark.parametrize("d", chip_smoke.ANYD_STRESS_DIMS)
def test_3xtf32_dkv_meets_the_fp32_tolerances_where_1xtf32_fails(d, kind):
    """The fp32 any-head-dim dK/dV's products (dP^T, dV, dK) as 3xTF32
    tensor-core steps in the kernel's order land within phase 29's
    F32_MAX_REL / F32_L2_REL of flash_bwd_dkv_plain on its randn, peaked
    and rising-max inputs at N = 200 (a ragged last q tile); at 1xTF32
    they do not. This is why dP^T runs on the tensor cores beside dV and
    dK, each in 3xTF32."""
    q, k, v, do = stress_inputs(kind, (1, 200, 2, d), seed=d, count=4)
    out, lse = tfa.flash_attention_plain(q, k, v, return_lse=True)
    want = tfa.flash_bwd_dkv_plain(q, k, v, do, lse, tfa.rowsum_do_o(do, out))
    for terms in (3, 1):
        errs = [rel_errors(g, w) for g, w in zip(_dkv_tf32(q, k, v, do, terms), want)]
        inside = all(m <= chip_smoke.F32_MAX_REL and l2 <= chip_smoke.F32_L2_REL
                     for m, l2 in errs)
        assert inside == (terms == 3), (terms, errs)
