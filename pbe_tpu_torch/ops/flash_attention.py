"""Fused flash attention, forward and backward: the Hopper kernels and
their plain versions.

Replaces the Pallas kernels of ``pbe_tpu/ops/flash_attention.py`` that the
port's paths reach: the forward kernels ``_flash_kernel_rowblock`` (UNet
self-attention) and ``_flash_kernel`` (streamed; VAE mid-block attention),
and the backward kernels ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel`` of the training step. All four Pallas forward
variants compute the same function:

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

The kernels, ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``, are built
with nvcc at first use and bound with ctypes. Layout: (B, N, H, D) with
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
    """``pbe_flash_fwd_bf16`` (csrc/flash_fwd.cu): (q, k, v) -> O [, LSE]."""

    def __init__(self):
        super().__init__("flash_fwd", "pbe_flash_fwd_bf16",
                         [_PTR] * 5 + [_I32] * 4 + [_I64] * 9 + [_F32, _PTR])

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 return_lse: bool = False):
        _check_operands("flash kernel", SUPPORTED_HEAD_DIMS, q=q, k=k, v=v)
        b, n, h, d = q.shape
        out = torch.empty((b, n, h, d), device=q.device, dtype=q.dtype)
        lse = (torch.empty((b * h, n), device=q.device, dtype=torch.float32)
               if return_lse else None)
        self._launch((b, n, h, d), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), None if lse is None else lse.data_ptr(),
                     b, n, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     d ** -0.5 * LOG2E, torch.cuda.current_stream(q.device).cuda_stream)
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
flash_bwd_dq = FlashBackward("dq")
flash_bwd_dkv = FlashBackward("dkv")


def _forward(q, k, v, return_lse=False):
    if q.device.type == "cuda":
        return flash_fwd(q, k, v, return_lse)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, return_lse)
    raise ValueError(f"flash attention has no path for device {q.device}")


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
            return _forward(q, k, v)
        out, lse = _forward(q, k, v, return_lse=True)
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
        return _forward(q, k, v, return_lse=True)
    return FlashAttention.apply(q, k, v)
