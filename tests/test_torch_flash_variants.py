"""The port's variant-selecting forward (``flash_forward``), the resident
kernel's cluster plan, the attention benchmark entry and the forward
kernel's tile sweep, on the CPU. The resident and pipelined CUDA kernels
themselves are held against the plain version on the card by
chip_smoke.py; here every variant runs the plain version and launches
nothing."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pbe_tpu.ops import flash_attention as jfa

from pbe_tpu_torch.ops import flash_attention as tfa
from pbe_tpu_torch.scripts import bench_attention as bench
from pbe_tpu_torch.scripts import sweep_flash_tiles as sweep

KERNELS = (tfa.flash_fwd, tfa.flash_fwd_resident, tfa.flash_fwd_pipelined,
           tfa.flash_bwd_dq, tfa.flash_bwd_dkv)


def _qkv(shape, seed=0):
    g = np.random.default_rng(seed)
    return [g.standard_normal(shape).astype(np.float32) for _ in range(3)]


def test_pipelined_multichunk_matches_pallas_kernel():
    """Four key chunks of 64, as tests/test_flash_attention.py runs the
    Pallas kernel; the port's block_c names the same chunk."""
    q, k, v = _qkv((2, 256, 40), seed=1)
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = jfa._flash_fwd_bhnd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128,
            return_stats=True, variant="pipelined", block_c=64)
    as_bnhd = lambda a: torch.from_numpy(a)[:, :, None, :]
    got, got_lse = tfa.flash_forward(as_bnhd(q), as_bnhd(k), as_bnhd(v),
                                     variant="pipelined", block_c=64, return_lse=True)
    np.testing.assert_allclose(got[:, :, 0].numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0], atol=1e-4)


@pytest.mark.parametrize("block_c", [32, 64])
def test_pipelined_wide_matches_pallas_kernel(block_c):
    """The VAE's head dim 512 at N=128, in chunks of block_c (the port's
    d=512 kernel splits the head dim over warps)."""
    q, k, v = _qkv((1, 128, 512), seed=4)
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = jfa._flash_fwd_bhnd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=128,
            return_stats=True, variant="pipelined", block_c=block_c)
    as_bnhd = lambda a: torch.from_numpy(a)[:, :, None, :]
    got, got_lse = tfa.flash_forward(as_bnhd(q), as_bnhd(k), as_bnhd(v),
                                     variant="pipelined", block_c=block_c, return_lse=True)
    np.testing.assert_allclose(got[:, :, 0].numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0], atol=1e-4)


# several key blocks of the online softmax at (2, 256, 40), and the VAE's
# head dim at N=128, against the Pallas resident kernel with a q block of 128
@pytest.mark.parametrize("shape, block_k", [
    ((2, 256, 40), 32), ((2, 256, 40), 64), ((2, 256, 40), 128), ((1, 128, 512), 32)])
def test_resident_multiblock_matches_pallas_kernel(shape, block_k):
    q, k, v = _qkv(shape, seed=3)
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = jfa._flash_fwd_bhnd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128, block_k=block_k,
            return_stats=True, variant="resident")
    as_bnhd = lambda a: torch.from_numpy(a)[:, :, None, :]
    got, got_lse = tfa.flash_forward(as_bnhd(q), as_bnhd(k), as_bnhd(v),
                                     variant="resident", block_k=block_k, return_lse=True)
    np.testing.assert_allclose(got[:, :, 0].numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0], atol=1e-4)


def test_cpu_tensors_launch_no_kernel_under_any_variant():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 64, 2, 40), seed=2))
    want, want_lse = tfa.flash_attention_plain(q, k, v, return_lse=True)
    before = [x.launches for x in KERNELS]
    for variant in tfa.VARIANTS:
        got, got_lse = tfa.flash_forward(q, k, v, variant=variant, return_lse=True)
        assert torch.equal(got, want) and torch.equal(got_lse, want_lse)
    assert [x.launches for x in KERNELS] == before


def test_unknown_variant_and_foreign_blocks_raise():
    q = torch.zeros(1, 64, 1, 40)
    with pytest.raises(ValueError, match="unknown flash variant"):
        tfa.flash_forward(q, q, q, variant="blocked")
    with pytest.raises(ValueError, match="block_k is the resident"):
        tfa.flash_forward(q, q, q, variant="pipelined", block_k=64)
    with pytest.raises(ValueError, match="block_c is the pipelined"):
        tfa.flash_forward(q, q, q, variant="auto", block_c=64)
    with pytest.raises(ValueError, match="not instantiated"):
        tfa.flash_forward(q, q, q, variant="pipelined", block_c=512)
    with pytest.raises(ValueError, match="not instantiated"):
        tfa.flash_forward(torch.zeros(1, 64, 1, 160), *[torch.zeros(1, 64, 1, 160)] * 2,
                          variant="resident", block_k=128)
    with pytest.raises(ValueError, match="head dim 64 unsupported"):
        tfa.flash_forward(*[torch.zeros(1, 64, 1, 64)] * 3, variant="resident")


# the benchmark's shapes and ds8: q tiles of 64 rows (32 at d=512) a head,
# and the B*H heads' tiles against 4 x 132 SMs
@pytest.mark.parametrize("shape, cluster", [
    ((2, 4096, 8, 40), 4),   # 64 q tiles a head, 1024 in all
    ((2, 1024, 8, 80), 2),   # 16, 256 in all
    ((2, 256, 8, 160), 2),   # 4, 64 in all
    ((2, 64, 8, 160), 1),    # 1
    ((2, 4096, 1, 512), 2),  # 128, 256 in all: the VAE shape shares key tiles too
])
def test_resident_cluster_size(shape, cluster):
    assert tfa.resident_cluster(shape) == cluster
    assert tfa.flash_fwd_resident.plan(shape) == [tfa.key_block("resident", shape[3]),
                                                  cluster]


@pytest.mark.parametrize("shape, sms, cluster", [
    ((2, 1024, 8, 80), 64, 4),    # 256 q tiles fill 64 SMs 4 times over
    ((2, 4096, 8, 40), 264, 2),   # 1024 q tiles fill 264 SMs under 4 times
])
def test_resident_cluster_follows_the_card_sm_count(shape, sms, cluster):
    assert tfa.resident_cluster(shape, sms=sms) == cluster
    assert tfa.flash_fwd_resident.plan(shape, sms=sms)[1] == cluster


def test_resident_refuses_the_vae_shape_and_cpu_tensors():
    """The VAE shape is planned (no shape is refused for its K and V); a
    tensor off the card still reaches no kernel."""
    vae = torch.empty(2, 4096, 1, 512, device="meta")
    assert tfa.flash_fwd_resident.plan(vae.shape) == [32, 2]
    assert tfa.flash_fwd_resident.plan(vae.shape, cluster=4) == [32, 4]
    with pytest.raises(ValueError, match="cluster of 8 blocks"):
        tfa.flash_fwd_resident.plan(vae.shape, cluster=8)
    with pytest.raises(ValueError, match="no path for device meta"):
        tfa.flash_forward(vae, vae, vae, variant="resident")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_resident(vae, vae, vae)
    x = torch.zeros(2, 64, 8, 160, dtype=torch.bfloat16)
    for kernel in (tfa.flash_fwd_resident, tfa.flash_fwd_pipelined):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(x, x, x)


def test_bench_entry_on_the_cpu(capsys):
    rows = bench.main(["--device", "cpu", "--repeats", "1"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines[0] == {"card": None, "device": "cpu"}
    assert lines[1:] == rows and len(rows) == 1
    keys = {"shape", "bh", "n", "d", "impl", "blocks", "us", "ideal_unpadded_us",
            "ideal_padded_us", "mxu_util_vs_unpadded"}  # scripts/bench_attention.py's
    assert keys <= rows[0].keys()
    assert (rows[0]["impl"], rows[0]["shape"], rows[0]["device"]) == ("plain", "tiny", "cpu")
    assert rows[0]["us"] > 0 and rows[0]["ideal_padded_us"] > rows[0]["ideal_unpadded_us"]


def test_bench_plan_over_the_card_shapes():
    """Every (shape, impl, blocks) line the card run prints, decided from
    the shapes alone: every line is timed (the resident kernel takes the
    VAE shape), every resident and pipelined line names its key block, and
    the models' kernel is timed once a shape."""
    plan = bench.configs(bench.SHAPES, bench.IMPLS)
    by = {(name, impl, None if blocks is None else blocks[0]) for name, impl, blocks in plan}
    assert len(by) == len(plan) == 28
    assert [impl for _, impl, _ in plan].count("auto") == len(bench.SHAPES)
    assert ("vae_mid", "resident", 32) in by and ("unet_ds1", "resident", 128) in by
    assert ("unet_ds4", "pipelined", 128) in by and ("unet_ds4", "resident", 128) not in by
    assert {impl for _, impl, _ in plan} == set(bench.IMPLS)


@pytest.mark.parametrize("setting", sweep.SETTINGS)
def test_tile_sweep_rewrites_only_its_tiles(setting):
    """Each setting of the tile sweep (built and timed on the card) changes
    exactly the launch lines it names, or exp2 inside the softmax step for
    ``ftz``, and leaves the rest of csrc/flash_fwd.cu as it is."""
    import re

    shipped = sweep.variant_source("")
    spec = setting.split(":", 1)[1]
    src = sweep.variant_source(spec)
    tiles = lambda s: dict(re.findall(r"launch_fwd<(\d+), (\d+, \d+)>", s))
    want = tiles(shipped)
    for item in spec.split(","):
        if "=" in item:
            dp, t = item.split("=")
            want[dp] = t.replace("x", ", ")
    assert tiles(src) == want and len(want) == 5
    if spec == "ftz":
        # the softmax step (csrc/mma_sm90.cuh) takes PBE_SOFTMAX_EXP2
        assert src.count("#define PBE_SOFTMAX_EXP2 ex2_ftz") == 1
        assert src.replace(sweep.FTZ_EXP2, "") == shipped
    else:
        assert "ex2_ftz" not in src
    with pytest.raises(ValueError, match="head dim 64"):
        sweep.variant_source("64=4x64")


@pytest.mark.parametrize("setting", sweep.BWD_SETTINGS)
def test_bwd_tile_sweep_rewrites_only_its_tiles(setting):
    """Each backward setting of the tile sweep changes exactly the
    launch_dq / launch_dkv lines it names in csrc/flash_bwd.cu (HOLD 1/0
    written as true/false) and nothing else."""
    import re

    shipped = sweep.variant_source("", "flash_bwd")
    spec = setting.split(":", 1)[1]
    src = sweep.variant_source(spec, "flash_bwd")
    tiles = lambda s: dict(re.findall(r"launch_((?:dq|dkv)<\d+), ([^>]+)>\(a, s\)", s))
    want = tiles(shipped)
    for item in filter(None, spec.split(",")):
        key, args = item.split("=")
        kern, dp = re.fullmatch(r"(dq|dkv)(\d+)", key).groups()
        vals = args.split("x")
        vals[2] = {"1": "true", "0": "false"}[vals[2]]
        want[f"{kern}<{dp}"] = ", ".join(vals)
    assert tiles(src) == want and len(want) == 10
    unchanged = lambda s: re.sub(r"launch_(dq|dkv)<\d+, [^>]+>\(a, s\)", "", s)
    assert unchanged(src) == unchanged(shipped)
    with pytest.raises(ValueError, match="names no launch line"):
        sweep.variant_source("48=4x64", "flash_bwd")
    with pytest.raises(ValueError, match="takes warps, bk, hold, minb"):
        sweep.variant_source("dq48=4x64", "flash_bwd")


@pytest.mark.parametrize("setting", sweep.VARIANT_SETTINGS)
def test_variant_sweep_rewrites_only_its_constants(setting):
    """Each setting of the resident/pipelined sweep changes exactly the
    constants it names in csrc/flash_variants.cu and nothing else."""
    import re

    shipped = sweep.variant_source("", "flash_variants")
    spec = setting.split(":", 1)[1]
    src = sweep.variant_source(spec, "flash_variants")
    names = "|".join(sweep.VARIANT_CONSTANTS.values())
    consts = lambda x: dict(re.findall(rf"constexpr int ({names}) = (\d+);", x))
    want = consts(shipped)
    for item in filter(None, spec.split(",")):
        key, val = item.split("=")
        want[sweep.VARIANT_CONSTANTS[key]] = val
    assert consts(src) == want and len(want) == 3
    strip = lambda x: re.sub(rf"({names}) = \d+", "", x)
    assert strip(src) == strip(shipped)


def test_library_key_covers_the_shared_headers(tmp_path, monkeypatch):
    """The sources include csrc/*.cuh, so an edited header must give a new
    library path (a rebuild), not the library built from the old one."""
    import shutil

    from pbe_tpu_torch.ops import cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", csrc / "build")
    headers = sorted(csrc.glob("*.cuh"))
    names = ("flash_fwd", "flash_variants", "flash_bwd")
    assert headers and all(f'#include "{h.name}"' in (csrc / f"{n}.cu").read_text()
                           for h in headers for n in names)
    before = {n: cuda_build.library_path(n) for n in names}
    assert before == {n: cuda_build.library_path(n) for n in before}  # stable
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in before}
    assert all(after[n] != before[n] and after[n].parent == csrc / "build" for n in before)
