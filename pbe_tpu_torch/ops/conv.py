"""The UNet's convs (``models/layers.QuantConv2d``) and their im2col.

On the H100, cuDNN's kernels for the UNet's 3x3 convs give the rows of a
batch other roundings at other batch positions (at 18 of the UNet's 3x3
shapes at batch 4, 8 or 16; its 1x1 convs and cuBLAS's products treat
every row alike; measured by ``chip_smoke.py`` phase 13). A request's
result would then depend on the row it lands in, which its batch-mates
decide. So a conv with a kernel wider than 1 over more than one example,
with no gradient taken, runs as an im2col and one cuBLAS product, which
treats every row alike; training keeps cuDNN. The int8 convs
(``ops/quant.py``) share the im2col.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def as_dtype(t: torch.Tensor | None, dtype: torch.dtype) -> torch.Tensor | None:
    """A layer's weight or bias in the activations' dtype: ``t`` itself
    where it already is (as ``Tensor.to`` would return it, but with no call,
    so a traced program records no cast and no check for it)."""
    return t if t is None or t.dtype == dtype else t.to(dtype)


def im2col(x: torch.Tensor, kernel: tuple[int, int], stride: tuple[int, int],
           padding: tuple[int, int]) -> tuple[torch.Tensor, int, int]:
    """NCHW x -> ((B*Ho*Wo, kh*kw*C) rows, Ho, Wo): each output position's
    zero-padded window, kernel taps outermost and channels innermost (the
    order of ``weight.permute(0, 2, 3, 1)``)."""
    b, c, h, w = x.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    xn = x.permute(0, 2, 3, 1)
    if kh == kw == 1 and (sh, sw) == (1, 1) and (ph, pw) == (0, 0):
        return xn.reshape(b * h * w, c), h, w
    xp = F.pad(xn, (0, 0, pw, pw, ph, ph))
    cols = torch.stack([xp[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw]
                        for i in range(kh) for j in range(kw)], dim=3)
    return cols.reshape(b * ho * wo, kh * kw * c), ho, wo


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           stride: tuple[int, int], padding: tuple[int, int],
           dilation: tuple[int, int] = (1, 1), groups: int = 1) -> torch.Tensor:
    """``F.conv2d``, except as the module docstring says: without autograd,
    a conv wider than 1x1 over more than one example is an im2col and one
    product, so every example's rows are computed alike."""
    kh, kw = weight.shape[2:]
    if (x.shape[0] == 1 or kh * kw == 1 or torch.is_grad_enabled() or groups != 1
            or tuple(dilation) != (1, 1)):
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    cols, ho, wo = im2col(x, (kh, kw), tuple(stride), tuple(padding))
    out = cols @ weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1).t()
    if bias is not None:
        out = out + bias
    return out.reshape(x.shape[0], ho, wo, -1).permute(0, 3, 1, 2).contiguous()
