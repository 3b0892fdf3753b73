"""The d = 512 backward pair of csrc/flash_bwd.cu (K5/K6 at the VAE's head
dim) as far as the CPU can hold it: its launch geometry, mirrored in
``ops.flash_attention.wide_bwd_launch`` and tied here to the source's
constants, covers every row and head-dim column once and fits a block's
shared memory; and the wrapper refuses operand layouts that the kernels'
TMA tensor copies cannot read. The kernels themselves run only on the card
(chip_smoke.py phase 17 holds them to their plain versions)."""
import re
from pathlib import Path

import pytest
import torch

from pbe_tpu_torch.ops import flash_attention as tfa

SOURCE = (Path(tfa.__file__).resolve().parent.parent / "csrc" / "flash_bwd.cu").read_text()
SMEM_PER_BLOCK = 232448  # an H100 block's shared memory, kSmemPerBlock


def _constant(name: str) -> int:
    return int(re.search(rf"static constexpr (?:int|uint32_t) {name} = (\d+);", SOURCE)[1])


@pytest.mark.parametrize("n", [20, 63, 65, 77, 1000, 4096])
def test_wide_launch_covers_every_row_once(n):
    """Block x of the grid takes rows [64 (x // 2), + 64) of its head and
    head-dim half x % 2: each row of every head, and each of the 512
    columns, has exactly one owner; rows past N belong to no block's
    output; the block's shared memory fits."""
    b, h = 2, 3
    plan = tfa.wide_bwd_launch((b, n, h, 512))
    gx, gy = plan["grid"]
    assert gy == b * h and gx % plan["cluster"] == 0
    owners = torch.zeros(n, 512, dtype=torch.int64)
    for x in range(gx):
        r0, half = (x // plan["cluster"]) * plan["rows"], x % plan["cluster"]
        owners[r0:min(r0 + plan["rows"], n), 256 * half:256 * half + 256] += 1
        assert r0 < n  # no block lies wholly past N
    assert bool((owners == 1).all())
    assert plan["smem"] <= SMEM_PER_BLOCK


def test_wide_launch_matches_the_kernels_source():
    """wide_bwd_launch's constants and shared-memory count are the ones
    struct Wide / WideBwd and launch_wide use."""
    assert (_constant("ROWS"), _constant("TR"), _constant("HALF"), _constant("THREADS"),
            _constant("STAGES")) == (tfa.WIDE_BWD_ROWS, tfa.WIDE_BWD_TILE, 256,
                                    tfa.WIDE_BWD_THREADS, 3)
    assert SOURCE.count("__cluster_dims__(2, 1, 1)") == 2 and tfa.WIDE_BWD_CLUSTER == 2
    assert "dim3(2 * ((a.N + T::ROWS - 1) / T::ROWS), a.B * a.H)" in SOURCE
    rows, tr, half = _constant("ROWS"), _constant("TR"), _constant("HALF")
    smem = (2 * rows * half * 2 + _constant("STAGES") * 2 * tr * half * 2 + 2 * 4 * rows * tr * 4
            + _constant("STAGES") * 2 * tr * 4 + _constant("BARS") * 8 + 1024)
    assert tfa.wide_bwd_launch((1, 1024, 1, 512))["smem"] == smem == 231328
    assert "231,328 B" in SOURCE
    # both entries dispatch the padded head dim 512 to the pair
    assert SOURCE.count("case 512: return (int)launch_wide<") == 2


def _bf16(shape, strides, offset=0):
    return torch.zeros(10 ** 6, dtype=torch.bfloat16).as_strided(shape, strides, offset)


@pytest.mark.parametrize("case", ["head_dim_stride", "row_stride", "head_stride", "base"])
@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_wrapper_refuses_what_tma_cannot_read(case, which):
    """A head-dim stride other than 1, a row, head or batch stride that is
    not a multiple of 16 bytes, or a base not 16-byte aligned is refused
    with a ValueError naming the operand and its layout, before any device
    question (on the card the tensor-map encoder would refuse them)."""
    shape = (1, 64, 1, 512)
    good = _bf16(shape, (64 * 512, 512, 512, 1))
    bad = {"head_dim_stride": _bf16(shape, (64 * 1024, 1024, 1024, 2)),
           "row_stride": _bf16(shape, (64 * 516, 516, 516, 1)),
           "head_stride": _bf16(shape, (64 * 1024, 1024, 516, 1)),
           "base": _bf16(shape, (64 * 512, 512, 512, 1), offset=4)}[case]
    assert tfa.layout_error(bad) is not None and tfa.layout_error(good) is None
    stats = torch.zeros(1, 64)
    kernel = tfa.flash_bwd_dq if which == "dq" else tfa.flash_bwd_dkv
    with pytest.raises(ValueError, match=r"do needs a unit head-dim stride and rows and base "
                                         r"aligned to 8 elements"):
        kernel(good, good, good, bad, stats, stats)
    launches = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):  # a layout it can read: refused for the device
        kernel(good, good, good, good, stats, stats)
    assert kernel.launches == launches


def test_wrapper_takes_packed_qkv_views():
    """q, k and v as the strided views of one packed (B, N, 3, 1, 512)
    tensor (phase 17's packed check) pass the layout check: their row
    stride is 3 * 512 elements."""
    q, k, v = torch.zeros(2, 65, 3, 1, 512, dtype=torch.bfloat16).unbind(2)
    assert q.stride() == (65 * 3 * 512, 3 * 512, 512, 1)
    assert all(tfa.layout_error(x) is None for x in (q, k, v))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dkv(q, k, v, q, torch.zeros(2, 65), torch.zeros(2, 65))
