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

The kernels in ``csrc/`` are built with nvcc at first use and bound with
ctypes. Layout: (B, N, H, D) with
strides, as the attention projections produce it, so no transpose copy is
made; the LSE and D are (B*H, N).

Dispatch is by the tensor's device: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises. :class:`FlashAttention` is the
autograd function: its forward keeps the LSE only when an input needs a
gradient, and its backward runs the two backward kernels.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from pbe_tpu_torch.ops import cuda_build

LOG2E = 1.4426950408889634  # log2(e): exp(x) == exp2(x * LOG2E)
# padded head dims instantiated in csrc/flash_fwd.cu: 48/80/160/512 serve
# configs/v1.yaml (d = 40, 80, 160 and the VAE's 512), 16/32 configs/tiny.yaml
SUPPORTED_HEAD_DIMS = (16, 32, 48, 80, 160, 512)
# ... and in csrc/flash_bwd.cu: the UNet's; the VAE (d=512) is frozen
BWD_HEAD_DIMS = (16, 32, 48, 80, 160)
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
    head-dim stride and 16-byte aligned rows and base (bf16 x 8)."""
    if x.dim() != 4:
        return f"expected (B,N,H,D), got shape {tuple(x.shape)}"
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        return (f"needs a unit head-dim stride and 16-byte aligned rows and base, "
                f"got strides {x.stride()}")
    if x.shape[3] % 8 or _round_up(x.shape[3], 16) not in SUPPORTED_HEAD_DIMS:
        return (f"head dim {x.shape[3]} unsupported (a multiple of 8 padding to one of "
                f"{SUPPORTED_HEAD_DIMS})")
    return None


def key_block(variant: str, d: int, block: int | None = None) -> int:
    """The key block the resident (block_k) or pipelined (block_c) kernel
    runs at head dim d: ``block``, or by default 64 (32 from a padded head
    dim of 160). Raises ValueError for a head dim or block it does not
    instantiate."""
    table = RESIDENT_BLOCKS if variant == "resident" else PIPELINED_BLOCKS
    dp = _round_up(d, 16)
    if dp not in table:
        raise ValueError(f"{variant}: head dim {d} unsupported (pads to one of {tuple(table)})")
    block = (64 if dp < 160 else 32) if block is None else block
    if block not in table[dp]:
        raise ValueError(f"{variant}: key block {block} is not instantiated at padded head "
                         f"dim {dp} (one of {table[dp]})")
    return block


def resident_cluster(shape: tuple, cluster: int | None = None, sms: int = SMS) -> int:
    """Blocks of a thread-block cluster of the resident kernel at (B, N, H,
    D), which share each key tile of one head: ``cluster``, or by default
    from the head's q-tile count: 4 where a head has 4 q tiles or more and
    all B*H heads' tiles fill the card's ``sms`` SMs 4 times over, else 2
    where a head has 2 or more, else 1. (Fewer blocks than that and a
    cluster of 4 waits on its slowest block, or a cluster has no 4 free SMs
    in one GPC: on an H100, 2 ran ds2 and the VAE shape faster and 4 ran
    ds1 faster, scripts/sweep_flash_tiles.py --variants.) Raises ValueError
    for a size it does not take."""
    b, n, h, d = shape
    if cluster is None:
        q_tiles = -(-n // RESIDENT_BLOCK_Q[_round_up(d, 16)])
        if q_tiles >= 4 and b * h * q_tiles >= 4 * sms:
            return 4
        return 2 if q_tiles >= 2 else 1
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"resident: a cluster of {cluster} blocks (one of {CLUSTER_SIZES})")
    return cluster


class _Kernel:
    """A kernel's ctypes entry point in ``csrc/<lib>.cu``, loaded at first
    launch, and its launch counts: ``launches`` in all and
    ``launches_by_shape`` by (B, N, H, D); both change only where the
    kernel is launched."""

    def __init__(self, lib: str, symbol: str, argtypes: list):
        self.lib, self.symbol, self.argtypes = lib, symbol, argtypes
        self.launches = 0
        self.launches_by_shape: collections.Counter = collections.Counter()
        self._fn = None

    def _launch(self, shape: tuple, *args) -> None:
        if self._fn is None:
            fn = getattr(cuda_build.load(self.lib), self.symbol)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {err} at "
                               f"(B,N,H,D)={shape}")
        self.launches += 1
        self.launches_by_shape[shape] += 1


def _check_operands(kernel: str, head_dims: tuple, **xs: torch.Tensor) -> None:
    """Raise unless every x is a bf16 (B,N,H,D) CUDA tensor of the first
    one's shape and device that the kernel can read in place."""
    first = next(iter(xs.values()))
    for name, x in xs.items():
        if x.device.type != "cuda" or x.device != first.device:
            raise ValueError(f"{kernel}: {name} must be on a CUDA device shared by all "
                             f"operands, got {x.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{kernel} takes bfloat16, {name} is {x.dtype}")
        if x.shape != first.shape:
            raise ValueError(f"{kernel}: operands must share one shape, got "
                             f"{tuple(first.shape)} and {name} {tuple(x.shape)}")
        err = layout_error(x)
        if err:
            raise ValueError(f"{kernel}: {name} {err}")
    if _round_up(first.shape[3], 16) not in head_dims:
        raise ValueError(f"{kernel}: head dim {first.shape[3]} unsupported (pads to one "
                         f"of {head_dims})")


_PTR, _I32, _I64, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class FlashForward(_Kernel):
    """A forward kernel: (q, k, v) -> O [, LSE]. ``variant`` None is
    ``pbe_flash_fwd_bf16`` (csrc/flash_fwd.cu), the models' kernels
    (K1/K2); "resident" ``pbe_flash_resident_bf16`` (K3) and "pipelined"
    ``pbe_flash_pipelined_bf16`` (K4), csrc/flash_variants.cu, take a key
    block ``block`` (block_k or block_c), and the resident kernel a
    ``cluster`` size."""

    def __init__(self, variant: str | None = None):
        self.variant = variant
        # [key block [, cluster size]]
        extra = {None: [], "resident": [_I32] * 2, "pipelined": [_I32]}[variant]
        super().__init__("flash_variants" if variant else "flash_fwd",
                         f"pbe_flash_{variant or 'fwd'}_bf16",
                         [_PTR] * 5 + [_I32] * 4 + [ctypes.POINTER(_I64), _F32] + extra
                         + [_PTR])

    def plan(self, shape: tuple, block: int | None = None, cluster: int | None = None,
             sms: int = SMS) -> list[int]:
        """The launch's extra arguments at (B, N, H, D) on a card of ``sms``
        SMs: none, [key block] (pipelined) or [key block, cluster size]
        (resident); raises ValueError where the kernel cannot take them, with
        the reason."""
        if self.variant is None:
            return []
        block = key_block(self.variant, shape[3], block)
        if self.variant != "resident":
            return [block]
        return [block, resident_cluster(tuple(shape), cluster, sms)]

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 return_lse: bool = False, block: int | None = None,
                 cluster: int | None = None):
        b, n, h, d = q.shape
        sms = (torch.cuda.get_device_properties(q.device).multi_processor_count
               if q.device.type == "cuda" else SMS)
        extra = self.plan(q.shape, block, cluster, sms)
        _check_operands(f"{self.variant or 'flash'} kernel", SUPPORTED_HEAD_DIMS,
                        q=q, k=k, v=v)
        out = torch.empty((b, n, h, d), device=q.device, dtype=q.dtype)
        lse = (torch.empty((b * h, n), device=q.device, dtype=torch.float32)
               if return_lse else None)
        strides = (_I64 * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
        self._launch((b, n, h, d), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), None if lse is None else lse.data_ptr(),
                     b, n, h, d, strides, d ** -0.5 * LOG2E, *extra,
                     torch.cuda.current_stream(q.device).cuda_stream)
        return (out, lse) if return_lse else out


class FlashBackward(_Kernel):
    """``pbe_flash_bwd_dq_bf16`` or ``pbe_flash_bwd_dkv_bf16``
    (csrc/flash_bwd.cu): (q, k, v, dO, LSE, D) -> dQ, or (dK, dV)."""

    def __init__(self, which: str):
        self.outputs = {"dq": 1, "dkv": 2}[which]
        super().__init__("flash_bwd", f"pbe_flash_bwd_{which}_bf16",
                         [_PTR] * (6 + self.outputs) + [_I32] * 4
                         + [ctypes.POINTER(_I64), _F32, _F32, _PTR])

    def __call__(self, q, k, v, do, lse, dd):
        _check_operands(f"flash backward ({self.symbol})", BWD_HEAD_DIMS,
                        q=q, k=k, v=v, do=do)
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
        self._launch((b, n, h, d), q.data_ptr(), k.data_ptr(), v.data_ptr(),
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


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  variant: str = "auto", block_k: int | None = None,
                  block_c: int | None = None, return_lse: bool = False):
    """(B,N,H,D) attention [, LSE] by one named forward variant: the port of
    ``_flash_fwd_bhnd``. "auto", "rowblock" and "streamed" run
    :data:`flash_fwd`; "resident" :data:`flash_fwd_resident` with key blocks
    of ``block_k``; "pipelined" :data:`flash_fwd_pipelined` with key chunks
    of ``block_c``. A name, block or shape that the variant's kernel does not
    take raises ValueError with the reason, on either device; no call moves
    to another variant. CUDA tensors launch the kernel (or raise); CPU
    tensors run :func:`flash_attention_plain`."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown flash variant {variant!r} (one of {VARIANTS})")
    if block_k is not None and variant != "resident":
        raise ValueError(f"block_k is the resident kernel's key block, not {variant}'s")
    if block_c is not None and variant != "pipelined":
        raise ValueError(f"block_c is the pipelined kernel's key chunk, not {variant}'s")
    kernel = {"resident": flash_fwd_resident, "pipelined": flash_fwd_pipelined}.get(variant)
    block = block_k if variant == "resident" else block_c
    if kernel is not None:
        kernel.plan(q.shape, block)  # raises here on either device
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention has no path for device {q.device}")
    if kernel is None:
        return flash_fwd(q, k, v, return_lse)
    return kernel(q, k, v, return_lse, block)


class FlashAttention(torch.autograd.Function):
    """The port of the JAX package's ``flash_attention`` custom VJP. The
    forward asks the kernel for the LSE only when an input needs a
    gradient and saves q, k, v, O and the LSE; the backward computes D
    and runs the dQ and dK/dV kernels on CUDA tensors (or raises), their
    plain versions on CPU tensors. Nothing falls back: a ragged N is
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
        if q.device.type != "cuda":
            return flash_attention_bwd_plain(q, k, v, o, lse, do)
        dd = rowsum_do_o(do, o)
        return (flash_bwd_dq(q, k, v, do, lse, dd),
                *flash_bwd_dkv(q, k, v, do, lse, dd))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    return_lse: bool = False):
    """(B,N,H,D) self-attention, differentiable through
    :class:`FlashAttention`. CUDA tensors run the Hopper kernels (or
    raise); CPU tensors run their plain versions. ``return_lse=True`` also
    returns the (B*H, N) log2-domain LSE, outside autograd."""
    if return_lse:
        return flash_forward(q, k, v, return_lse=True)
    return FlashAttention.apply(q, k, v)
