"""Linear and conv layers with fp32 parameters that compute in the input's
dtype: the weights are cast to the activation dtype at each call, as flax's
``dtype=bf16, param_dtype=f32`` layers do. ``QuantLinear``/``QuantConv2d``
are the UNet's: under an active ``ops.quant`` context they run in w8a8
where the op is eligible, as the JAX UNet's ``_dense``/``_conv`` do; every
other model's layers stay fp under it. ``QuantConv2d``'s fp conv is
``ops/conv.conv2d``, which computes every example of a batch alike."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from pbe_tpu_torch.ops import quant
from pbe_tpu_torch.ops.conv import as_dtype, conv2d


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, as_dtype(self.weight, x.dtype), as_dtype(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, as_dtype(self.weight, x.dtype), as_dtype(self.bias, x.dtype))


class QuantLinear(Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.is_active():
            return quant.linear_int8(x, self.weight, self.bias)
        return super().forward(x)


class QuantConv2d(Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.is_active():
            return quant.conv2d_int8(x, self.weight, self.bias, self.stride, self.padding,
                                     self.dilation, self.groups)
        return conv2d(x, as_dtype(self.weight, x.dtype), as_dtype(self.bias, x.dtype),
                      self.stride, self.padding, self.dilation, self.groups)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@torch.no_grad()
def init_like_flax(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded weights of the kinds flax's initializers give, drawn on the
    module's device in parameter order: lecun-normal (truncated) kernels,
    zero biases, unit norm scales, normal(0.02) embeddings (a CLIP tower's
    class and position embeddings) and normal(1.0) for PaintByExample's
    learnable vector."""
    gen = torch.Generator(device=next(module.parameters()).device).manual_seed(int(seed))
    for name, p in module.named_parameters():
        if name == "learnable_vector":
            p.normal_(0.0, 1.0, generator=gen)
        elif name.endswith(("class_embedding", "position_embedding.weight")):
            p.normal_(0.0, 0.02, generator=gen)
        elif name.endswith("weight") and p.dim() >= 2:
            # variance 1/fan_in, truncated at 2 std, the std corrected for it
            std = (1.0 / math.prod(p.shape[1:])) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=gen)
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    return module
