"""Fused flash-attention forward: the Hopper kernel and its plain version.

Replaces the two Pallas forward kernels the 512^2 edit reaches in
``pbe_tpu/ops/flash_attention.py``: ``_flash_kernel_rowblock`` (UNet
self-attention) and ``_flash_kernel`` (streamed; VAE mid-block attention).
All four Pallas forward variants compute the same function:

    q2  = round_to_dtype(q * d^-1/2 * log2(e))      (prescale, exp2 domain)
    S2  = q2 K^T                                    (fp32)
    P   = exp2(S2 - rowmax(S2)),  l = rowsum(P)     (fp32)
    O   = round_to_dtype((P.to(dtype) V) / l)
    LSE = rowmax(S2) + log2(l)                      (log2 domain, fp32)

The kernel, ``csrc/flash_fwd.cu``, is built with nvcc at first use and
bound with ctypes. Layout: (B, N, H, D) with strides, as the attention
projections produce it, so no transpose copy is made; the LSE is (B*H, N).

Dispatch is by the tensor's device: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises.
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


def prescale(q: torch.Tensor) -> torch.Tensor:
    """Fold d^-1/2 * log2(e) into q in fp32 and round back to q's dtype."""
    return (q.float() * (q.shape[-1] ** -0.5 * LOG2E)).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          return_lse: bool = False):
    """The kernel's arithmetic in torch ops. (B,N,H,D) -> (B,N,H,D)
    [, LSE (B*H, N) fp32 in the log2 domain]."""
    b, n, h, _ = q.shape
    heads = lambda x: x.permute(0, 2, 1, 3).float()  # (B,H,N,D) fp32
    s2 = heads(prescale(q)) @ heads(k).transpose(-1, -2)
    m = s2.amax(dim=-1, keepdim=True)
    p = torch.exp2(s2 - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = p.to(v.dtype).float() @ heads(v)
    out = (acc / l).to(v.dtype).permute(0, 2, 1, 3).contiguous()
    if not return_lse:
        return out
    return out, (m + torch.log2(l))[..., 0].reshape(b * h, n)


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


class FlashForward:
    """ctypes binding of ``pbe_flash_fwd_bf16`` (csrc/flash_fwd.cu).

    ``launches`` counts the kernel launches made through this wrapper and
    ``launches_by_shape`` the same launches by (B, N, H, D); both change
    only where the kernel is launched."""

    def __init__(self):
        self.launches = 0
        self.launches_by_shape: collections.Counter = collections.Counter()
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            fn = cuda_build.load("flash_fwd").pbe_flash_fwd_bf16
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr,             # q k v o lse
                           i32, i32, i32, i32,                  # B N H D
                           i64, i64, i64, i64, i64, i64, i64, i64, i64,
                           ctypes.c_float, ptr]                 # scale, stream
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 return_lse: bool = False):
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.device.type != "cuda" or x.device != q.device:
                raise ValueError(f"flash kernel: {name} must be on q's CUDA device, "
                                 f"got {x.device}")
            if x.dtype != torch.bfloat16:
                raise TypeError(f"flash kernel takes bfloat16, {name} is {x.dtype}")
            if x.shape != q.shape:
                raise ValueError(f"flash kernel: q, k, v must share one shape, got "
                                 f"{tuple(q.shape)} and {name} {tuple(x.shape)}")
            err = layout_error(x)
            if err:
                raise ValueError(f"flash kernel: {name} {err}")
        b, n, h, d = q.shape
        fn = self._kernel()
        out = torch.empty((b, n, h, d), device=q.device, dtype=q.dtype)
        lse = (torch.empty((b * h, n), device=q.device, dtype=torch.float32)
               if return_lse else None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 b, n, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 d ** -0.5 * LOG2E, stream)
        if err != 0:
            raise RuntimeError(f"flash kernel launch failed: CUDA error {err} "
                               f"at (B,N,H,D)={tuple(q.shape)}")
        self.launches += 1
        self.launches_by_shape[(b, n, h, d)] += 1
        return (out, lse) if return_lse else out


flash_fwd = FlashForward()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    return_lse: bool = False):
    """(B,N,H,D) self-attention. CUDA tensors run the Hopper kernel (or
    raise); CPU tensors run :func:`flash_attention_plain`."""
    if q.device.type == "cuda":
        return flash_fwd(q, k, v, return_lse)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, return_lse)
    raise ValueError(f"flash attention has no path for device {q.device}")
