"""The fp32 side of the port's flash-attention wrappers on the CPU: which
operand dtypes the CUDA path takes, which entry (csrc/flash_fp32.cu or the
bf16 sources) a launch loads, how launches are counted by dtype, which key
blocks the fp32 resident and pipelined kernels take, and the CLIs'
--precision full (fp32 on the card, TF32 off). The fp32 plain versions are
held against the Pallas kernels at fp32 by
tests/test_torch_flash_attention.py, tests/test_torch_flash_variants.py
(every variant, the resident one at d = 512 too) and
tests/test_torch_flash_backward.py; the CUDA kernels against their plain
versions on the card by chip_smoke.py (phases 20 and 11)."""
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from pbe_tpu_torch.ops import cuda_build
from pbe_tpu_torch.ops import flash_attention as fa
from pbe_tpu_torch.scripts import inference

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
    assert fa.operand_dtype("k", tuple(kern.entries), q=x, k=x, v=x) == dtype


@pytest.mark.parametrize("which", list(WRAPPERS))
@pytest.mark.parametrize("case", ["fp16", "mixed", "fp64"])
def test_cuda_dtype_check_rejects_other_and_mixed_dtypes(which, case):
    x = torch.zeros(1, 8, 1, 40)
    others = {"fp16": (x.half(), x.half()), "mixed": (x, x.bfloat16()),
              "fp64": (x.double(), x.double())}[case]
    with pytest.raises(TypeError, match="share one dtype" if case == "mixed" else "takes"):
        fa.operand_dtype("k", tuple(WRAPPERS[which].entries), q=others[0], k=others[1])


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
    bf16 key blocks, defaults included; a block only bf16 has is refused
    for fp32 operands on either device, naming the fp32 table."""
    f32 = torch.float32
    for variant in ("resident", "pipelined"):
        bf16_table, f32_table = fa.block_table(variant)[1], fa.block_table(variant, f32)[1]
        assert f32_table.keys() == bf16_table.keys() == set(fa.SUPPORTED_HEAD_DIMS)
        assert all(set(f32_table[dp]) <= set(bf16_table[dp]) for dp in f32_table)
        for dp in fa.SUPPORTED_HEAD_DIMS:
            assert fa.key_block(variant, dp, dtype=f32) == fa.key_block(variant, dp)
    for variant, dp, table in (("resident", 80, "RESIDENT_BLOCKS_F32"),
                               ("pipelined", 160, "PIPELINED_BLOCKS_F32")):
        assert fa.key_block(variant, dp, 128) == 128
        with pytest.raises(ValueError, match=rf"for float32 \({table}: one of \(32, 64\)\)"):
            fa.key_block(variant, dp, 128, f32)
        x = torch.zeros(1, 64, 1, dp)
        kw = {"block_k" if variant == "resident" else "block_c": 128}
        with pytest.raises(ValueError, match=table):
            fa.flash_forward(x, x, x, variant=variant, **kw)
        y = x.bfloat16()
        assert fa.flash_forward(y, y, y, variant=variant, **kw).dtype == torch.bfloat16
    # the benchmark's VAE shape at fp32: K4's 64-key chunks and K3's cluster
    vae = (2, 4096, 1, 512)
    assert fa.flash_fwd_pipelined.plan(vae, 64, dtype=f32) == [64]
    assert fa.flash_fwd_resident.plan(vae, dtype=f32) == [32, 2]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_the_operands_dtype_picks_the_block_table_before_the_plan(dtype, monkeypatch):
    """The resident kernel's call checks its operands first and plans by
    their dtype: a 128-key block at d = 80 launches for bf16 and is refused
    for fp32, after the check and before any launch."""
    calls = []
    monkeypatch.setattr(fa, "_check_operands", lambda *a, **kw: calls.append("check") or dtype)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=fa.SMS))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=0))
    kern = fa.FlashForward("resident")
    monkeypatch.setattr(kern, "_launch",
                        lambda dt, shape, *args: calls.append(("launch", dt, args[-3:-1])))
    x = torch.zeros(1, 64, 1, 80)
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="RESIDENT_BLOCKS_F32"):
            kern(x, x, x, block=128)
        assert calls == ["check"]
    else:
        kern(x, x, x, block=128)
        assert calls == ["check", ("launch", torch.bfloat16, (128, 1))]


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

