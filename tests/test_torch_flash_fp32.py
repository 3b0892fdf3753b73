"""The fp32 side of the port's flash-attention wrappers on the CPU: which
operand dtypes the CUDA path takes, which entry (csrc/flash_fp32.cu or the
bf16 sources) a launch loads, how launches are counted by dtype, and the
CLIs' --precision full (fp32 on the card, TF32 off). The fp32 plain
versions are held against the Pallas kernels at fp32 by
tests/test_torch_flash_attention.py and tests/test_torch_flash_backward.py;
the CUDA kernels against their plain versions on the card by chip_smoke.py
(phase 20)."""
import re
from pathlib import Path

import pytest
import torch

from pbe_tpu_torch.ops import cuda_build
from pbe_tpu_torch.ops import flash_attention as fa
from pbe_tpu_torch.scripts import inference

CSRC = Path(fa.__file__).resolve().parent.parent / "csrc"
WRAPPERS = {"fwd": fa.flash_fwd, "dq": fa.flash_bwd_dq, "dkv": fa.flash_bwd_dkv}


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


def test_resident_and_pipelined_kernels_take_bf16_only():
    x = torch.zeros(1, 8, 1, 40)
    for kern in (fa.flash_fwd_resident, fa.flash_fwd_pipelined):
        assert tuple(kern.entries) == (torch.bfloat16,)
        with pytest.raises(TypeError, match="takes bfloat16, got torch.float32"):
            fa.operand_dtype("k", tuple(kern.entries), q=x)


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

    kern = fa.FlashForward() if which == "fwd" else fa.FlashBackward(which)
    monkeypatch.setattr(cuda_build, "load", Lib)
    shape = (1, 8, 1, 40)
    kern._launch(torch.float32, shape)
    kern._launch(torch.float32, shape)
    kern._launch(torch.bfloat16, shape)
    sym = "fwd" if which == "fwd" else f"bwd_{which}"
    assert loaded == [("flash_fp32", f"pbe_flash_{sym}_f32"),
                      ("flash_fwd" if which == "fwd" else "flash_bwd", f"pbe_flash_{sym}_bf16")]
    assert kern.launches == 3 and kern.launches_by_shape == {shape: 3}
    assert kern.launches_by_dtype == {"float32": 2, "bfloat16": 1}
    kern.reset()
    assert (kern.launches, kern.launches_by_shape, kern.launches_by_dtype) == (0, {}, {})


def test_fp32_source_defines_every_fp32_entry_with_its_twins_arguments():
    """csrc/flash_fp32.cu exports the three symbols the wrappers load, each
    with its bf16 twin's parameter list (the wrappers share argtypes)."""
    def params(path, symbol):
        src = (CSRC / path).read_text()
        m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
        assert m, (path, symbol)
        return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]

    for sym, twin in (("fwd", "flash_fwd.cu"), ("bwd_dq", "flash_bwd.cu"),
                      ("bwd_dkv", "flash_bwd.cu")):
        assert (params("flash_fp32.cu", f"pbe_flash_{sym}_f32")
                == params(twin, f"pbe_flash_{sym}_bf16"))
    assert cuda_build.library_path("flash_fp32").name.startswith("libflash_fp32-")


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
