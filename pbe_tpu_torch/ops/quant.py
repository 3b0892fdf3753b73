"""w8a8 int8 matmuls and convs for serving (port of ``pbe_tpu/ops/quant.py``).

Scheme: symmetric int8 activations with one scale per example (amax over
the example's non-batch axes / 127, computed at each call, so a request's
quantization grid never depends on its batch-mates and EditServer's
batch invariance holds), or one scale per tensor, or calibrated constant
scales; symmetric per-output-channel weight scales, computed from the fp32
parameters at each call (one set of weights serves the fp and int8 paths).
The product is ``torch._int_mm`` (int8 x int8 -> int32, exact); a 3x3 or
strided conv goes through an im2col into the same product.

The mode is a thread-local switch (:func:`quantized`): only the UNet's own
``QuantLinear``/``QuantConv2d`` (models/layers.py) read it, as only the JAX
UNet's ``_dense``/``_conv`` pass the int8 overrides, so the VAE, the CLIP
tower and the exemplar encoder stay fp under it. EditPipeline enters it
around each edit of a pipeline built with ``quantize="int8"``.

Calibrated static scales: :func:`calibration` records each eligible op's
activation and weight amax while the fp UNet runs, :func:`scales_from_records`
turns the records into a tuple of (act_scale, weight_scales) in call
order, and ``quantized("int8", static=scales)`` uses them in that order,
modulo one UNet call's op count, checked when the context exits.

Given the same fp32 inputs, the int8 operands and the int32 accumulators
equal the JAX package's bit for bit: the same formulas in the same order
(``round(x / s)``, static ``round(x * (1 / s))``, rounding half to even,
then the clip to [-127, 127]), and integer products are exact.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

from pbe_tpu_torch.ops.conv import as_dtype, conv2d, im2col

# the JAX package's gates, the same numbers: ops below them stay fp
MIN_SPATIAL = 256      # H*W of the conv input
MIN_CHANNELS = 64      # conv in/out channels
MIN_CONTRACT = 128     # dense contraction dim
MIN_ROWS = 256         # dense rows per example

_TLS = threading.local()


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Which ops quantize and at what scale granularity (direct calls to
    the int8 functions outside any context use the defaults)."""

    mode: str = "int8"
    convs: bool = True      # w8a8 the eligible convs
    dense: bool = True      # w8a8 the eligible Linear matmuls
    per_row: bool = True    # per-example activation scales; False = per tensor
    # calibrated static scales: one (act_scale, weight_scales) per eligible
    # op, used in call order (from calibration() + scales_from_records())
    static: tuple | None = None


class _Ctx:
    """One active context: the spec, the eligible-op counter that walks the
    static scales, and the calibration records."""

    def __init__(self, spec: QuantSpec):
        self.spec = spec
        self.count = 0
        self.records: list = []  # calibration: (act_amax, w_amax) per op

    def next_static(self):
        st = self.spec.static
        idx = self.count % len(st)
        self.count += 1
        return st[idx]


def _stack() -> list:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


@contextmanager
def quantized(mode: str | None = "int8", **knobs):
    """Run the UNet's eligible matmuls and convs in w8a8 inside the block
    (this thread only). ``knobs`` (convs/dense/per_row/static) select a
    :class:`QuantSpec`; ``mode=None`` is a no-op."""
    if mode is None:
        yield
        return
    if mode != "int8":
        raise ValueError(f"unknown quantization mode {mode!r}")
    ctx = _Ctx(QuantSpec(mode=mode, **knobs))
    s = _stack()
    s.append(ctx)
    ok = False
    try:
        yield
        ok = True
    finally:
        s.pop()
        st = ctx.spec.static
        # checked only on a clean exit: an error mid-call leaves a partial
        # count, and raising here would hide it
        if ok and st and ctx.count % len(st) != 0:
            raise RuntimeError(
                f"static-scale mismatch: the block ran {ctx.count} eligible ops, not a "
                f"multiple of the {len(st)} calibrated scales: calibration and serving "
                "disagree on which ops quantize (did the model config or the "
                "convs/dense knobs change since calibration?)")


@contextmanager
def calibration(convs: bool = True, dense: bool = True):
    """Record each eligible op's (activation amax, per-output-channel weight
    amax) while the fp ops run; ``ctx.records`` holds them in call order.
    The convs/dense knobs must match the serving context's."""
    ctx = _Ctx(QuantSpec(mode="calib", convs=convs, dense=dense))
    s = _stack()
    s.append(ctx)
    try:
        yield ctx
    finally:
        s.pop()


def scales_from_records(per_batch_records) -> tuple:
    """Reduce calibration records (an iterable over runs, each a list of
    (act_amax scalar, w_amax vector) in op order, tensors or arrays) to the
    static-scales tuple: amaxes maxed over runs, divided by 127."""
    per_batch = [list(r) for r in per_batch_records]
    n = len(per_batch[0])
    out = []
    for i in range(n):
        a = max(float(_np(r[i][0])) for r in per_batch)
        w = np.max(np.stack([_np(r[i][1]).astype(np.float32).reshape(-1)
                             for r in per_batch]), axis=0)
        out.append((max(a / 127.0, 1e-8),
                    tuple(float(x) for x in np.maximum(w / 127.0, 1e-8))))
    return tuple(out)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def is_active() -> bool:
    return bool(_stack())


def active_ctx() -> _Ctx | None:
    s = _stack()
    return s[-1] if s else None


def active_spec() -> QuantSpec | None:
    ctx = active_ctx()
    return ctx.spec if ctx else None


# ---- operands -------------------------------------------------------------

def _to_int8(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v), -127.0, 127.0).to(torch.int8)


def quantize_rows(x: torch.Tensor, dims: tuple[int, ...]):
    """Symmetric int8 with one scale per index of the dims kept -> (q, s),
    s float32 with the reduced dims kept as size 1."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=dims, keepdim=True)
    # a tensor divisor: torch divides by a Python scalar on the card as a
    # product with its reciprocal, which is not always the quotient JAX's
    # division (and the CPU's) rounds to
    s = torch.clamp_min(amax / amax.new_full((), 127.0), 1e-8)
    return _to_int8(xf / s), s


def quantize_per_channel(w: torch.Tensor):
    """Per-output-channel (axis 0: a Linear's n, a conv's O) -> (q, s)."""
    return quantize_rows(w, tuple(range(1, w.dim())))


def quantize_static(x: torch.Tensor, s_act: float) -> torch.Tensor:
    return _to_int8(x.float() * (1.0 / s_act))


def quantize_static_weight(w: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """sw: (O,) float32 scales of the output channels."""
    return _to_int8(w.float() / sw.reshape((-1,) + (1,) * (w.dim() - 1)))


# ---- int8 products ----------------------------------------------------------

def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) int8 @ b (n, k)^T int8 -> (m, n) int32. torch._int_mm on
    the card takes more than 16 rows and k, n in multiples of 8: zero rows
    and columns make up the rest, which is exact in integer arithmetic."""
    m, k = a.shape
    n = b.shape[0]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pk, 0, pn))
    out = torch._int_mm(a.contiguous(), b.contiguous().t())
    return out[:m, :n] if pm or pn else out


def int8_linear_acc(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """qx (..., k) @ qw (n, k)^T -> (..., n) int32."""
    lead = qx.shape[:-1]
    return _int_mm(qx.reshape(-1, qx.shape[-1]), qw).reshape(*lead, qw.shape[0])


def int8_conv_acc(qx: torch.Tensor, qw: torch.Tensor, stride: tuple[int, int],
                  padding: tuple[int, int]) -> torch.Tensor:
    """The int32 conv of int8 NCHW qx with int8 OIHW qw (zero padding), as
    an im2col (``ops/conv.py``) into one product."""
    o, _, kh, kw = qw.shape
    cols, ho, wo = im2col(qx, (kh, kw), stride, padding)
    wmat = qw.permute(0, 2, 3, 1).reshape(o, -1)
    return _int_mm(cols, wmat).reshape(qx.shape[0], ho, wo, o).permute(0, 3, 1, 2)


# ---- the ops the UNet's layers call ------------------------------------------

def linear_int8(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., k) @ weight (n, k)^T + bias in w8a8 where eligible, else the
    exact fp op (weights cast to x's dtype, as ``layers.Linear`` does)."""
    w, b = as_dtype(weight, x.dtype), as_dtype(bias, x.dtype)
    spec = active_spec() or QuantSpec()
    n, k = w.shape
    # rows per example (the leading axis is the batch): a total-row gate
    # would quantize a layer in a large bucket and not in a small one, and
    # a request's result would then depend on its bucket
    m = int(np.prod(x.shape[1:-1])) if x.dim() > 2 else 1
    if not spec.dense or k < MIN_CONTRACT or n < MIN_CONTRACT or m < MIN_ROWS:
        return F.linear(x, w, b)
    ctx = active_ctx()
    if ctx is not None and ctx.spec.mode == "calib":
        ctx.records.append((torch.amax(torch.abs(x.float())),
                            torch.amax(torch.abs(w.float()), dim=1)))
        ctx.count += 1
        return F.linear(x, w, b)
    if spec.static is not None:
        s_act, s_w = ctx.next_static()
        if len(s_w) != n:
            raise RuntimeError(f"static weight-scale length {len(s_w)} != out dim {n}: "
                               "calibration/serving op order misaligned")
        sw = torch.tensor(s_w, dtype=torch.float32, device=x.device)
        acc = int8_linear_acc(quantize_static(x, s_act), quantize_static_weight(w, sw))
        out = (acc.float() * (s_act * sw)).to(x.dtype)
    else:
        ql, sl = quantize_rows(x, (x.dim() - 1,) if spec.per_row else tuple(range(x.dim())))
        qw, sr = quantize_per_channel(w)
        acc = int8_linear_acc(ql, qw)
        out = (acc.float() * (sl * sr.reshape(-1))).to(x.dtype)
    return out if b is None else out + b


def conv2d_int8(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                stride: tuple[int, int], padding: tuple[int, int],
                dilation: tuple[int, int] = (1, 1), groups: int = 1) -> torch.Tensor:
    """NCHW conv with OIHW weights in w8a8 where eligible, else the UNet's
    fp conv (``ops/conv.conv2d``, weights cast to x's dtype)."""
    w, b = as_dtype(weight, x.dtype), as_dtype(bias, x.dtype)
    spec = active_spec() or QuantSpec()
    _, cin, h, wd = x.shape
    cout = w.shape[0]
    if (not spec.convs or groups != 1 or tuple(dilation) != (1, 1) or h * wd < MIN_SPATIAL
            or cin < MIN_CHANNELS or cout < MIN_CHANNELS):
        return conv2d(x, w, b, stride, padding, dilation, groups)
    ctx = active_ctx()
    if ctx is not None and ctx.spec.mode == "calib":
        ctx.records.append((torch.amax(torch.abs(x.float())),
                            torch.amax(torch.abs(w.float()), dim=(1, 2, 3))))
        ctx.count += 1
        return conv2d(x, w, b, stride, padding, dilation, groups)
    stride, padding = tuple(stride), tuple(padding)
    if spec.static is not None:
        s_act, s_w = ctx.next_static()
        if len(s_w) != cout:
            raise RuntimeError(f"static weight-scale length {len(s_w)} != out channels "
                               f"{cout}: calibration/serving op order misaligned")
        sw = torch.tensor(s_w, dtype=torch.float32, device=x.device)
        acc = int8_conv_acc(quantize_static(x, s_act), quantize_static_weight(w, sw),
                            stride, padding)
        out = (acc.float() * (s_act * sw.reshape(1, cout, 1, 1))).to(x.dtype)
    else:
        ql, sl = quantize_rows(x, (1, 2, 3) if spec.per_row else (0, 1, 2, 3))
        qw, sr = quantize_per_channel(w)
        acc = int8_conv_acc(ql, qw, stride, padding)
        out = (acc.float() * (sl * sr.reshape(1, cout, 1, 1))).to(x.dtype)
    # NCHW in memory, as the fp conv's result is (the im2col product is NHWC)
    out = out.contiguous()
    return out if b is None else out + b.reshape(1, cout, 1, 1)
