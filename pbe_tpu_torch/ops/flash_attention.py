"""Fused flash attention, forward and backward: the Hopper kernels and
their plain versions.

Replaces the six Pallas kernels of ``pbe_tpu/ops/flash_attention.py``: the
forward kernels ``_flash_kernel_rowblock`` (UNet self-attention) and
``_flash_kernel`` (streamed; VAE mid-block attention), served by two
kernels of ``csrc/flash_fwd.cu`` behind one entry (the VAE's d=512 takes
its own); ``_flash_kernel_resident`` and ``_flash_kernel_pipelined``,
the kernels of ``csrc/flash_variants.cu``, which only a named variant of
:func:`flash_forward` reaches; and the backward kernels
``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel`` of the training step.
All four Pallas forward variants compute the same function:

    q2  = round_to_dtype(q * d^-1/2 * log2(e))      (prescale, exp2 domain)
    S2  = q2 K^T                                    (fp32)
    P   = exp2(S2 - rowmax(S2)),  l = rowsum(P)     (fp32)
    O   = round_to_dtype((P.to(dtype) V) / l)
    LSE = rowmax(S2) + log2(l)                      (log2 domain, fp32)

and the backward recomputes P from the same q2 and the LSE:

    P  = exp2(S2 - LSE),  D = rowsum(dO * O)         (fp32)
    dS = P * (dO V^T - D) * d^-1/2                   (fp32)
    dQ = round(dS.to(dtype) K)                       (dQ kernel)
    dV = round(P.to(dtype)^T dO),  dK = round(dS.to(dtype)^T Q)   (dK/dV kernel)

At fp32 (``--precision full``) every round_to_dtype and cast above does
nothing, as in the Pallas kernels, which run in their operands' dtype: all
four forward variants and the backward pair then launch the fp32 kernels of
``csrc/flash_fp32.cu`` (one wrapper each, the entry picked by the operands'
dtype). The resident and pipelined kernels' key blocks are instantiated per
dtype (fp32 tiles are twice the bytes).

The kernels in ``csrc/`` are built with nvcc at first use and bound with
ctypes. Layout: (B, N, H, D) with
strides, as the attention projections produce it, so no transpose copy is
made; the LSE and D are (B*H, N).

Each kernel is also a ``torch.library`` custom op in the ``pbe`` namespace
(``pbe.flash_fwd``, ``pbe.flash_fwd_lse``, ``pbe.flash_bwd_dq``,
``pbe.flash_bwd_dkv``), with a fake implementation and a FLOP formula, so an
exported program holds one node a call. Dispatch is by the tensor's device,
inside the op: a CPU tensor takes the plain version, a CUDA tensor launches
the kernel or raises. :class:`FlashAttention` is the autograd function: its
forward keeps the LSE only when an input needs a gradient, and its backward
runs the two backward ops.
"""
from __future__ import annotations

import collections
import ctypes

import torch
import torch.utils.flop_counter

from pbe_tpu_torch.ops import cuda_build

LOG2E = 1.4426950408889634  # log2(e): exp(x) == exp2(x * LOG2E)
# padded head dims instantiated in csrc/flash_fwd.cu and csrc/flash_fp32.cu:
# 48/80/160/512 serve configs/v1.yaml (d = 40, 80, 160 and the VAE's 512),
# 16/32 configs/tiny.yaml
SUPPORTED_HEAD_DIMS = (16, 32, 48, 80, 160, 512)
# ... and in csrc/flash_bwd.cu and csrc/flash_fp32.cu: the UNet's, and the
# VAE's 512 for first-stage training (training/vae_train.py)
BWD_HEAD_DIMS = (16, 32, 48, 80, 160, 512)
# q tile of csrc/flash_variants.cu's resident kernel by padded head dim
# (ResidentTile, ResidentWideTile): the cluster is planned over these tiles
RESIDENT_BLOCK_Q = {**{dp: 64 for dp in (16, 32, 48, 80, 160)}, 512: 32}
# key blocks instantiated by padded head dim in csrc/flash_variants.cu: the
# resident kernel's block_k (past these, S of a whole key tile leaves too few
# registers) and the pipelined kernel's block_c (at d=512, K and V chunks of
# 128 rows do not fit beside the rest)
RESIDENT_BLOCKS = {**{dp: (32, 64, 128) for dp in (16, 32, 48, 80)}, 160: (32, 64),
                   512: (32,)}
PIPELINED_BLOCKS = {**{dp: (32, 64, 128) for dp in (16, 32, 48, 80, 160)}, 512: (32, 64)}
# ... and in csrc/flash_fp32.cu for fp32 operands: the resident kernel's
# 128-key tiles from a padded head dim of 80 and the pipelined kernel's
# 128-key chunks at 160 are not built (at 160 their two K and two V slots
# alone would take 336 KB of shared memory)
RESIDENT_BLOCKS_F32 = {**{dp: (32, 64, 128) for dp in (16, 32, 48)}, 80: (32, 64),
                       160: (32, 64), 512: (32,)}
PIPELINED_BLOCKS_F32 = {**{dp: (32, 64, 128) for dp in (16, 32, 48, 80)}, 160: (32, 64),
                        512: (32, 64)}


def variant_tile_f32(dp: int, block: int, resident: bool) -> tuple[int, int, int]:
    """(MT, RG, SPLIT) of csrc/flash_fp32.cu's resident (K3) or pipelined
    (K4) kernel at padded head dim ``dp`` and key block ``block``, as its
    VarTile (WideVar<2, 2, 4, BK> at 512) picks them: 8 consumer warps in RG
    row groups of 16 MT rows, SPLIT warps a group; 32-row warps in pairs for
    K4 below d = 160 and K3 at d = 80 (key blocks below 128), else 16-row
    warps, one a group where it holds O's whole row (d <= 48, key blocks
    below 128)."""
    if dp == 512:
        return 2, 2, 4
    if (not resident or dp == 80) and dp <= 80 and block < 128:
        return 2, 4, 2
    split = (2 if block == 128 else 1) if dp <= 48 else 2 if dp == 80 else 4
    return 1, 8 // split, split


# q tile of csrc/flash_fp32.cu's resident kernel by padded head dim and key
# block (16 MT RG rows): its cluster plan at fp32 is over these tiles
RESIDENT_BLOCK_Q_F32 = {dp: {bk: 16 * mt * rg for bk in blocks
                             for mt, rg, _ in [variant_tile_f32(dp, bk, True)]}
                        for dp, blocks in RESIDENT_BLOCKS_F32.items()}
VARIANTS = ("auto", "rowblock", "streamed", "resident", "pipelined")
CLUSTER_SIZES = (1, 2, 4)  # the resident kernel's blocks a cluster
# streaming multiprocessors of an H100 SXM: the resident kernel's plan off
# the card (a CUDA tensor's plan reads its device's count)
SMS = 132


def prescale(q: torch.Tensor) -> torch.Tensor:
    """Fold d^-1/2 * log2(e) into q in fp32 and round back to q's dtype."""
    return (q.float() * (q.shape[-1] ** -0.5 * LOG2E)).to(q.dtype)


def _heads(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 1, 3).float()  # (B,N,H,D) -> (B,H,N,D) fp32


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          return_lse: bool = False):
    """The kernel's arithmetic in torch ops. (B,N,H,D) -> (B,N,H,D)
    [, LSE (B*H, N) fp32 in the log2 domain]."""
    b, n, h, _ = q.shape
    s2 = _heads(prescale(q)) @ _heads(k).transpose(-1, -2)
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = p.to(v.dtype).float() @ _heads(v)
    out = (acc / l).to(v.dtype).permute(0, 2, 1, 3).contiguous()
    if not return_lse:
        return out
    return out, (m + torch.log2(l))[..., 0].reshape(b * h, n)


def rowsum_do_o(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32: (B,N,H,D) -> (B*H, N). A torch pass
    before the dQ kernel, as it is an XLA pass before the Pallas kernels."""
    b, n, h, _ = o.shape
    return (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(b * h, n).contiguous()


def _p_ds(q, k, v, do, lse, dd):
    """P and dS (B,H,N,N) fp32 of the backward contract."""
    b, n, h, d = q.shape
    s2 = _heads(prescale(q)) @ _heads(k).transpose(-1, -2)
    p = torch.exp2(s2 - lse.reshape(b, h, n, 1))
    dp = _heads(do) @ _heads(v).transpose(-1, -2)
    return p, p * (dp - dd.reshape(b, h, n, 1)) * d ** -0.5


def flash_bwd_dq_plain(q, k, v, do, lse, dd) -> torch.Tensor:
    """The dQ kernel's arithmetic in torch ops -> dQ (B,N,H,D)."""
    _, ds = _p_ds(q, k, v, do, lse, dd)
    dq = ds.to(q.dtype).float() @ _heads(k)
    return dq.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def flash_bwd_dkv_plain(q, k, v, do, lse, dd) -> tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel's arithmetic in torch ops -> (dK, dV) (B,N,H,D)."""
    p, ds = _p_ds(q, k, v, do, lse, dd)
    dv = p.to(do.dtype).float().transpose(-1, -2) @ _heads(do)
    dk = ds.to(q.dtype).float().transpose(-1, -2) @ _heads(q)
    back = lambda x, like: x.to(like.dtype).permute(0, 2, 1, 3).contiguous()
    return back(dk, k), back(dv, v)


def flash_attention_bwd_plain(q, k, v, o, lse, do):
    """The backward of :func:`flash_attention_plain` as the two kernels
    compute it: (q, k, v, o, LSE (B*H, N), dO) -> (dQ, dK, dV)."""
    dd = rowsum_do_o(do, o)
    return (flash_bwd_dq_plain(q, k, v, do, lse, dd),
            *flash_bwd_dkv_plain(q, k, v, do, lse, dd))


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def layout_error(x: torch.Tensor) -> str | None:
    """Why the kernel cannot read x in place, or None: it takes a unit
    head-dim stride and rows and base aligned to 8 elements (16 bytes of
    bf16, 32 of fp32)."""
    if x.dim() != 4:
        return f"expected (B,N,H,D), got shape {tuple(x.shape)}"
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        return (f"needs a unit head-dim stride and rows and base aligned to 8 elements, "
                f"got strides {x.stride()}")
    return head_dim_error(x.shape[3])


def head_dim_error(d: int) -> str | None:
    """Why the kernels have no instantiation for head dim d, or None."""
    if d % 8 or _round_up(d, 16) not in SUPPORTED_HEAD_DIMS:
        return f"head dim {d} unsupported (a multiple of 8 padding to one of {SUPPORTED_HEAD_DIMS})"
    return None


def block_table(variant: str, dtype: torch.dtype = torch.bfloat16) -> tuple[str, dict]:
    """(name, table) of the key blocks the resident or pipelined kernel
    instantiates for operands of ``dtype``: the fp32 tables for float32, the
    bf16 ones for any other (the CPU runs the plain version at any dtype)."""
    name = ("RESIDENT_BLOCKS" if variant == "resident" else "PIPELINED_BLOCKS") + (
        "_F32" if dtype == torch.float32 else "")
    return name, globals()[name]


def key_block(variant: str, d: int, block: int | None = None,
              dtype: torch.dtype = torch.bfloat16) -> int:
    """The key block the resident (block_k) or pipelined (block_c) kernel
    runs at head dim d on ``dtype`` operands: ``block``, or by default 64
    (32 from a padded head dim of 160). Raises ValueError, naming the table,
    for a head dim or block it does not instantiate."""
    name, table = block_table(variant, dtype)
    dp = _round_up(d, 16)
    if dp not in table:
        raise ValueError(f"{variant}: head dim {d} unsupported (pads to one of {tuple(table)})")
    block = (64 if dp < 160 else 32) if block is None else block
    if block not in table[dp]:
        raise ValueError(f"{variant}: key block {block} is not instantiated at padded head "
                         f"dim {dp} for {_dtype_name(dtype)} ({name}: one of {table[dp]})")
    return block


def resident_cluster(shape: tuple, cluster: int | None = None, sms: int = SMS,
                     dtype: torch.dtype = torch.bfloat16, block: int | None = None) -> int:
    """Blocks of a thread-block cluster of the resident kernel at (B, N, H,
    D) on ``dtype`` operands with key tiles of ``block`` (default: the
    kernel's), which share each key tile of one head: ``cluster``, or by
    default from the head's q-tile count. bf16: 4 where a head has 4 q
    tiles or more and all B*H heads' tiles fill the card's ``sms`` SMs 4
    times over, else 2 where a head has 2 or more, else 1. (Fewer blocks
    than that and a cluster of 4 waits on its slowest block, or a cluster
    has no 4 free SMs in one GPC: on an H100, 2 ran ds2 and the VAE shape
    faster and 4 ran ds1 faster, scripts/sweep_flash_tiles.py --variants.)
    fp32: 1 at d = 512, else 2 where a head has 2 q tiles
    (RESIDENT_BLOCK_Q_F32) or more, else 1 (a block's producer copies a key
    tile row by row: below 512 two blocks sharing the rows ran faster, at
    512, rows of 2 KB, one block alone did; chip_smoke.py phase 11's C =
    1/2/4 times at the benchmark's shapes). Raises ValueError for a size it
    does not take."""
    b, n, h, d = shape
    if cluster is None:
        dp, f32 = _round_up(d, 16), dtype == torch.float32
        q_tiles = -(-n // (RESIDENT_BLOCK_Q_F32[dp][key_block("resident", d, block, dtype)]
                           if f32 else RESIDENT_BLOCK_Q[dp]))
        if not f32 and q_tiles >= 4 and b * h * q_tiles >= 4 * sms:
            return 4
        return 2 if q_tiles >= 2 and not (f32 and dp == 512) else 1
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"resident: a cluster of {cluster} blocks (one of {CLUSTER_SIZES})")
    return cluster


# csrc/flash_bwd.cu's d = 512 pair (struct Wide, WideBwd): blocks of 64 rows
# (one wgmma M) in clusters of 2 that split the head dim, 32-row streamed
# tiles, 384 threads, a ring of 3 stages
WIDE_BWD_ROWS, WIDE_BWD_TILE, WIDE_BWD_CLUSTER, WIDE_BWD_THREADS = 64, 32, 2, 384


def wide_bwd_launch(shape: tuple) -> dict:
    """The launch of the d = 512 backward kernels at (B, N, H, D), as
    csrc/flash_bwd.cu's launch_wide makes it: a grid of (2 ceil(N / 64),
    B*H) blocks in clusters of 2, block 2 i + r on rows [64 i, 64 i + 64) of
    head y and head-dim half r ([256 r, 256 r + 256)); and the dynamic
    shared memory a block asks for, counted as WideBwd counts it (the
    resident halves, the ring, the exchange slots, the statistics, 20
    barriers and 1 KB to align the base)."""
    b, n, h, _ = shape
    rows, tile, half = WIDE_BWD_ROWS, WIDE_BWD_TILE, 256
    res, streamed, slot = rows * half * 2, tile * half * 2, rows * tile * 4
    smem = 2 * res + 3 * 2 * streamed + 2 * 4 * slot + 3 * 2 * tile * 4 + 20 * 8 + 1024
    return {"grid": (WIDE_BWD_CLUSTER * -(-n // rows), b * h), "cluster": WIDE_BWD_CLUSTER,
            "rows": rows, "tile": tile, "threads": WIDE_BWD_THREADS, "smem": smem}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class _Kernel:
    """A kernel's ctypes entry points by operand dtype, ``entries[dtype] =
    (csrc/<lib>.cu, symbol)`` (``lib`` and ``symbol``: the bf16 one), each
    loaded at its first launch, and the launch counts: ``launches`` in all,
    ``launches_by_shape`` by (B, N, H, D) and ``launches_by_dtype`` by the
    operands' dtype name ("bfloat16", "float32"); they change only where a
    kernel is launched, and :meth:`reset` sets them to 0."""

    def __init__(self, entries: dict, argtypes: list):
        self.entries, self.argtypes = entries, argtypes
        self.lib, self.symbol = entries[torch.bfloat16]
        self.launches = 0
        self.launches_by_shape: collections.Counter = collections.Counter()
        self.launches_by_dtype: collections.Counter = collections.Counter()
        self._fns: dict = {}

    def reset(self) -> None:
        self.launches = 0
        self.launches_by_shape.clear()
        self.launches_by_dtype.clear()

    def _launch(self, dtype: torch.dtype, shape: tuple, *args) -> None:
        fn = self._fns.get(dtype)
        if fn is None:
            lib, symbol = self.entries[dtype]
            fn = getattr(cuda_build.load(lib), symbol)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            self._fns[dtype] = fn
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.entries[dtype][1]} launch failed: CUDA error {err} at "
                               f"(B,N,H,D)={shape}")
        self.launches += 1
        self.launches_by_shape[shape] += 1
        self.launches_by_dtype[_dtype_name(dtype)] += 1


def operand_dtype(kernel: str, dtypes, **xs: torch.Tensor) -> torch.dtype:
    """The one dtype of the operands xs, which must be one of ``dtypes``
    (the kernel's entries); raises TypeError for any other or for a mix."""
    got = {x.dtype for x in xs.values()}
    if len(got) != 1:
        raise TypeError(f"{kernel}: operands must share one dtype, got "
                        + ", ".join(f"{n} {x.dtype}" for n, x in xs.items()))
    dtype = got.pop()
    if dtype not in dtypes:
        raise TypeError(f"{kernel} takes {' or '.join(map(_dtype_name, dtypes))}, "
                        f"got {dtype}")
    return dtype


def _check_operands(kernel: str, head_dims: tuple, dtypes, **xs: torch.Tensor) -> torch.dtype:
    """Raise unless every x is a (B,N,H,D) CUDA tensor of the first one's
    shape, device and dtype, that dtype one of ``dtypes``, which the kernel
    can read in place; returns the dtype. The layout is checked first, so
    a strided or misaligned view is refused for its layout on any device."""
    first = next(iter(xs.values()))
    for name, x in xs.items():
        if x.shape != first.shape:
            raise ValueError(f"{kernel}: operands must share one shape, got "
                             f"{tuple(first.shape)} and {name} {tuple(x.shape)}")
        err = layout_error(x)
        if err:
            raise ValueError(f"{kernel}: {name} {err}")
    for name, x in xs.items():
        if x.device.type != "cuda" or x.device != first.device:
            raise ValueError(f"{kernel}: {name} must be on a CUDA device shared by all "
                             f"operands, got {x.device}")
    dtype = operand_dtype(kernel, dtypes, **xs)
    if _round_up(first.shape[3], 16) not in head_dims:
        raise ValueError(f"{kernel}: head dim {first.shape[3]} unsupported (pads to one "
                         f"of {head_dims})")
    return dtype


_PTR, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class FlashForward(_Kernel):
    """A forward kernel: (q, k, v) -> O [, LSE]. ``variant`` None is the
    models' kernels (K1/K2): ``pbe_flash_fwd_bf16`` (csrc/flash_fwd.cu) for
    bf16 operands and ``pbe_flash_fwd_f32`` (csrc/flash_fp32.cu) for fp32;
    "resident" (K3) and "pipelined" (K4) ``pbe_flash_{variant}_bf16``
    (csrc/flash_variants.cu) for bf16 and ``pbe_flash_{variant}_f32``
    (csrc/flash_fp32.cu) for fp32, which take a key block ``block``
    (block_k or block_c; instantiated per dtype, :func:`block_table`), and
    the resident kernel a ``cluster`` size."""

    def __init__(self, variant: str | None = None):
        self.variant = variant
        self.lse_launches = 0  # the launches that also wrote the LSE
        # [key block [, cluster size]]
        extra = {None: [], "resident": [_I32] * 2, "pipelined": [_I32]}[variant]
        entries = {torch.bfloat16: ("flash_variants" if variant else "flash_fwd",
                                    f"pbe_flash_{variant or 'fwd'}_bf16"),
                   torch.float32: ("flash_fp32", f"pbe_flash_{variant or 'fwd'}_f32")}
        super().__init__(entries, [_PTR] * 5 + [_I32] * 4 + [ctypes.POINTER(_I64), _F32]
                         + extra + [_PTR])

    def reset(self) -> None:
        super().reset()
        self.lse_launches = 0

    def plan(self, shape: tuple, block: int | None = None, cluster: int | None = None,
             sms: int = SMS, dtype: torch.dtype = torch.bfloat16) -> list[int]:
        """The launch's extra arguments at (B, N, H, D) for ``dtype``
        operands on a card of ``sms`` SMs: none, [key block] (pipelined) or
        [key block, cluster size] (resident); raises ValueError where the
        kernel cannot take them, with the reason."""
        if self.variant is None:
            return []
        block = key_block(self.variant, shape[3], block, dtype)
        if self.variant != "resident":
            return [block]
        return [block, resident_cluster(tuple(shape), cluster, sms, dtype, block)]

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 return_lse: bool = False, block: int | None = None,
                 cluster: int | None = None):
        b, n, h, d = q.shape
        # the operands first: the dtype picks the entry and the block table
        dtype = _check_operands(f"{self.variant or 'flash'} kernel", SUPPORTED_HEAD_DIMS,
                                tuple(self.entries), q=q, k=k, v=v)
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        extra = self.plan(q.shape, block, cluster, sms, dtype)
        out = torch.empty((b, n, h, d), device=q.device, dtype=q.dtype)
        lse = (torch.empty((b * h, n), device=q.device, dtype=torch.float32)
               if return_lse else None)
        strides = (_I64 * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
        self._launch(dtype, (b, n, h, d), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), None if lse is None else lse.data_ptr(),
                     b, n, h, d, strides, d ** -0.5 * LOG2E, *extra,
                     torch.cuda.current_stream(q.device).cuda_stream)
        self.lse_launches += return_lse
        return (out, lse) if return_lse else out


class FlashBackward(_Kernel):
    """``pbe_flash_bwd_dq_bf16`` or ``pbe_flash_bwd_dkv_bf16``
    (csrc/flash_bwd.cu) for bf16 operands, ``pbe_flash_bwd_dq_f32`` or
    ``pbe_flash_bwd_dkv_f32`` (csrc/flash_fp32.cu) for fp32: (q, k, v, dO,
    LSE, D) -> dQ, or (dK, dV). At d = 512 the bf16 kernels read q, k, v
    and dO by TMA tensor copies, which take a unit head-dim stride, other
    strides in multiples of 16 bytes and a 16-byte aligned base: the
    layout check (:func:`layout_error`) refuses anything else."""

    def __init__(self, which: str):
        self.outputs = {"dq": 1, "dkv": 2}[which]
        super().__init__({torch.bfloat16: ("flash_bwd", f"pbe_flash_bwd_{which}_bf16"),
                          torch.float32: ("flash_fp32", f"pbe_flash_bwd_{which}_f32")},
                         [_PTR] * (6 + self.outputs) + [_I32] * 4
                         + [ctypes.POINTER(_I64), _F32, _F32, _PTR])

    def __call__(self, q, k, v, do, lse, dd):
        dtype = _check_operands(f"flash backward ({self.symbol})", BWD_HEAD_DIMS,
                                tuple(self.entries), q=q, k=k, v=v, do=do)
        b, n, h, d = q.shape
        for name, x in (("lse", lse), ("D", dd)):
            if (x.dtype != torch.float32 or x.shape != (b * h, n)
                    or not x.is_contiguous() or x.device != q.device):
                raise ValueError(f"flash backward: {name} must be contiguous float32 "
                                 f"(B*H, N) = {(b * h, n)} on {q.device}, got {x.dtype} "
                                 f"{tuple(x.shape)} on {x.device}")
        outs = [torch.empty((b, n, h, d), device=q.device, dtype=q.dtype)
                for _ in range(self.outputs)]
        strides = (_I64 * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                              *do.stride()[:3])
        self._launch(dtype, (b, n, h, d), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
                     *(x.data_ptr() for x in outs), b, n, h, d, strides,
                     d ** -0.5 * LOG2E, d ** -0.5,
                     torch.cuda.current_stream(q.device).cuda_stream)
        return outs[0] if self.outputs == 1 else tuple(outs)


flash_fwd = FlashForward()
flash_fwd_resident = FlashForward("resident")
flash_fwd_pipelined = FlashForward("pipelined")
flash_bwd_dq = FlashBackward("dq")
flash_bwd_dkv = FlashBackward("dkv")


# The kernels as torch.library custom ops, so that torch.export, a CUDA
# graph capture and torch.utils.flop_counter see each call as one node. Each
# op dispatches by its operands' device: its CUDA kernel calls the wrapper
# above (which checks the layout, launches and counts), its CPU kernel runs
# the plain version, and neither falls back to the other. ``kind`` is
# "fwd" (K1/K2), "resident" (K3) or "pipelined" (K4); ``block`` is the
# variant's key block, 0 for the kernel's default (the resident kernel's
# cluster is its own choice). The fake implementations give shapes and
# dtypes only.
#
# Launch counts (``launches``, ``launches_by_shape``, ``launches_by_dtype``)
# change in the wrappers' ``_launch``, so they count every call that runs an
# op's CUDA kernel: the live edit's, and an exported program's as it runs.
# Under a captured CUDA graph they count once, at capture: a replay launches
# the recorded kernels without running Python.
_FWD_KERNELS = {"fwd": flash_fwd, "resident": flash_fwd_resident,
                "pipelined": flash_fwd_pipelined}


def _fwd_cuda(q, k, v, kind, block, return_lse):
    kernel = _FWD_KERNELS[kind]
    if kernel is flash_fwd:
        return flash_fwd(q, k, v, return_lse)
    return kernel(q, k, v, return_lse, block or None)


@torch.library.custom_op("pbe::flash_fwd", mutates_args=(), device_types="cpu")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kind: str,
                  block: int) -> torch.Tensor:
    return flash_attention_plain(q, k, v)


@torch.library.custom_op("pbe::flash_fwd_lse", mutates_args=(), device_types="cpu")
def _flash_fwd_lse_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kind: str,
                      block: int) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_plain(q, k, v, return_lse=True)


@torch.library.custom_op("pbe::flash_bwd_dq", mutates_args=(), device_types="cpu")
def _flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                     lse: torch.Tensor, dd: torch.Tensor) -> torch.Tensor:
    return flash_bwd_dq_plain(q, k, v, do, lse, dd)


@torch.library.custom_op("pbe::flash_bwd_dkv", mutates_args=(), device_types="cpu")
def _flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                      lse: torch.Tensor, dd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_bwd_dkv_plain(q, k, v, do, lse, dd)


@_flash_fwd_op.register_kernel("cuda")
def _(q, k, v, kind, block):
    return _fwd_cuda(q, k, v, kind, block, False)


@_flash_fwd_lse_op.register_kernel("cuda")
def _(q, k, v, kind, block):
    return _fwd_cuda(q, k, v, kind, block, True)


_flash_bwd_dq_op.register_kernel("cuda")(lambda q, k, v, do, lse, dd:
                                          flash_bwd_dq(q, k, v, do, lse, dd))
_flash_bwd_dkv_op.register_kernel("cuda")(lambda q, k, v, do, lse, dd:
                                           flash_bwd_dkv(q, k, v, do, lse, dd))


def _dense(x: torch.Tensor) -> torch.Tensor:
    """(B,N,H,D) of x's shape and dtype, as the kernels and the plain
    versions write their outputs."""
    return x.new_empty(x.shape)


@_flash_fwd_op.register_fake
def _(q, k, v, kind, block):
    return _dense(q)


@_flash_fwd_lse_op.register_fake
def _(q, k, v, kind, block):
    b, n, h, _ = q.shape
    return _dense(q), q.new_empty((b * h, n), dtype=torch.float32)


@_flash_bwd_dq_op.register_fake
def _(q, k, v, do, lse, dd):
    return _dense(q)


@_flash_bwd_dkv_op.register_fake
def _(q, k, v, do, lse, dd):
    return _dense(k), _dense(v)


def _flops(factor: int):
    """A FLOP formula of ``factor`` * B*H*N^2*D (the multiply-adds of the
    op's products, two FLOPs each, as chip_smoke.py's bounds count them):
    4 for the forward (S and P V), 6 for dQ (dP, S and dQ), 8 for dK/dV
    (S, dP, dV and dK)."""
    def formula(q_shape, *args, **kwargs) -> int:
        b, n, h, d = q_shape
        return factor * b * h * n * n * d
    return formula


for _op, _factor in ((torch.ops.pbe.flash_fwd, 4), (torch.ops.pbe.flash_fwd_lse, 4),
                     (torch.ops.pbe.flash_bwd_dq, 6), (torch.ops.pbe.flash_bwd_dkv, 8)):
    torch.utils.flop_counter.register_flop_formula(_op)(_flops(_factor))


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  variant: str = "auto", block_k: int | None = None,
                  block_c: int | None = None, return_lse: bool = False):
    """(B,N,H,D) attention [, LSE] by one named forward variant: the port of
    ``_flash_fwd_bhnd``. "auto", "rowblock" and "streamed" run
    :data:`flash_fwd`; "resident" :data:`flash_fwd_resident` with key blocks
    of ``block_k``; "pipelined" :data:`flash_fwd_pipelined` with key chunks
    of ``block_c``. A name, block or shape that the variant's kernel does not
    take raises ValueError with the reason, on either device; no call moves
    to another variant. The call is one ``pbe.flash_fwd`` (or
    ``pbe.flash_fwd_lse``) op: CUDA tensors launch the kernel (or raise);
    CPU tensors run :func:`flash_attention_plain`."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown flash variant {variant!r} (one of {VARIANTS})")
    if block_k is not None and variant != "resident":
        raise ValueError(f"block_k is the resident kernel's key block, not {variant}'s")
    if block_c is not None and variant != "pipelined":
        raise ValueError(f"block_c is the pipelined kernel's key chunk, not {variant}'s")
    kind = variant if variant in ("resident", "pipelined") else "fwd"
    block = (block_k if variant == "resident" else block_c) or 0
    if kind != "fwd":
        _FWD_KERNELS[kind].plan(q.shape, block or None, dtype=q.dtype)  # raises here on either device
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention has no path for device {q.device}")
    op = torch.ops.pbe.flash_fwd_lse if return_lse else torch.ops.pbe.flash_fwd
    return op(q, k, v, kind, block)


def kernel_cotangent(do: torch.Tensor) -> torch.Tensor:
    """The cotangent as the backward kernels take it: ``do`` itself where
    they can read it in place, else a dense copy in a new allocation
    (autograd hands over any strides: the cotangent of ``out.sum()`` is
    expanded, all strides 0; a dense view at an odd offset is misaligned,
    and ``contiguous()`` would return it as it is)."""
    return do.clone(memory_format=torch.contiguous_format) if layout_error(do) else do


class FlashAttention(torch.autograd.Function):
    """The port of the JAX package's ``flash_attention`` custom VJP. The
    forward asks the kernel for the LSE only when an input needs a
    gradient and saves q, k, v, O and the LSE; the backward computes D
    and runs the ``pbe.flash_bwd_dq`` and ``pbe.flash_bwd_dkv`` ops (the
    kernels on CUDA tensors, or raise; their plain versions on CPU tensors)
    on :func:`kernel_cotangent`'s dO. Nothing falls back: a ragged N is
    masked inside the kernels."""

    @staticmethod
    def forward(ctx, q, k, v):
        if not any(ctx.needs_input_grad):
            return flash_forward(q, k, v)
        out, lse = flash_forward(q, k, v, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = kernel_cotangent(do)
        dd = rowsum_do_o(do, o)
        return (torch.ops.pbe.flash_bwd_dq(q, k, v, do, lse, dd),
                *torch.ops.pbe.flash_bwd_dkv(q, k, v, do, lse, dd))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    return_lse: bool = False):
    """(B,N,H,D) self-attention, differentiable through
    :class:`FlashAttention`. CUDA tensors run the Hopper kernels (or
    raise); CPU tensors run their plain versions. ``return_lse=True`` also
    returns the (B*H, N) log2-domain LSE, outside autograd."""
    if return_lse:
        return flash_forward(q, k, v, return_lse=True)
    return FlashAttention.apply(q, k, v)
