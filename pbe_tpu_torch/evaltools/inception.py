"""InceptionV3 pool3 feature extractor (FID backbone; port of
``pbe_tpu/evaltools/inception.py``), an ``nn.Module`` taking NHWC input.

Architecture: torchvision's ``Inception3`` as the reference's
eval_tool/fid/inception.py (pytorch-fid) uses it. The pytorch-fid tweak —
``count_include_pad=False`` average pools inside the Inception blocks and a
max-pool branch in the last InceptionE — is ``fid_pools``, since the FID
weights assume it. BatchNorm runs in inference form (eps 1e-3).

Weights: the module's keys are torchvision's, so any ``Inception3``
state_dict loads with :func:`load_torchvision_state_dict` (``fc`` and
``AuxLogits`` dropped); nothing is downloaded — bring your own file.
:func:`state_dict_from_flax` carries the JAX package's params across.

Input: (B, 299, 299, 3) in [0,1]; ``normalize_input`` maps it to [-1,1] as
pytorch-fid does. Output: (B, 2048) pool3 features.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm (inference, eps 1e-3) -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         training=False, eps=bn.eps)
        return F.relu(x)


def _avg_pool(x: torch.Tensor, fid_pools: bool) -> torch.Tensor:
    """3x3 stride-1 average pool, padding 1; pytorch-fid's blocks leave the
    padding out of the count (count_include_pad=False), torchvision's
    count it."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=not fid_pools)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, fid_pools: bool = True):
        super().__init__()
        self.fid_pools = fid_pools
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x, self.fid_pools))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, fid_pools: bool = True):
        super().__init__()
        self.fid_pools = fid_pools
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                      self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avg_pool(x, self.fid_pools))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """``pool_kind`` "avg" (Mixed_7b) or "max" (Mixed_7c under fid_pools:
    pytorch-fid's FIDInceptionE_2)."""

    def __init__(self, cin: int, pool_kind: str = "avg", fid_pools: bool = True):
        super().__init__()
        self.pool_kind, self.fid_pools = pool_kind, fid_pools
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        if self.pool_kind == "max":
            pool = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            pool = _avg_pool(x, self.fid_pools)
        return torch.cat([b1, b3, bd, self.branch_pool(pool)], dim=1)


class InceptionV3Features(nn.Module):
    """(B, H, W, 3) in [0,1] (299² for FID) -> (B, 2048) pool3 features."""

    def __init__(self, fid_pools: bool = True, normalize_input: bool = True):
        super().__init__()
        self.fid_pools, self.normalize_input = fid_pools, normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fid_pools)
        self.Mixed_5c = InceptionA(256, 64, fid_pools)
        self.Mixed_5d = InceptionA(288, 64, fid_pools)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid_pools)
        self.Mixed_6c = InceptionC(768, 160, fid_pools)
        self.Mixed_6d = InceptionC(768, 160, fid_pools)
        self.Mixed_6e = InceptionC(768, 192, fid_pools)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg", fid_pools)
        self.Mixed_7c = InceptionE(2048, "max" if fid_pools else "avg", fid_pools)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        if self.normalize_input:
            x = x * 2.0 - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # adaptive average pool -> 2048


def load_torchvision_state_dict(model: InceptionV3Features,
                                state_dict: Mapping[str, Any]) -> InceptionV3Features:
    """Load a torchvision ``Inception3`` state_dict by its own keys (``fc``
    and ``AuxLogits`` dropped), strictly otherwise."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()
          if k.split(".")[0] not in ("fc", "AuxLogits")}
    model.load_state_dict(sd, strict=True)
    return model


@torch.no_grad()
def init_random(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights (no weights file): truncated lecun-normal conv
    kernels, as flax initializes the JAX module, and identity BatchNorm."""
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            std = (1.0 / math.prod(m.weight.shape[1:])) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


def state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """The JAX package's InceptionV3Features params (numpy) -> this module's
    (torchvision's) state_dict: kernels (kh, kw, in, out) -> (out, in, kh,
    kw), bn_scale/bias/mean/var -> bn.weight/bias/running_mean/running_var."""
    names = {"bn_scale": "bn.weight", "bn_bias": "bn.bias", "bn_mean": "bn.running_mean",
             "bn_var": "bn.running_var"}
    out: dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping) and k != "conv":
                walk(v, prefix + (k,))
            elif k == "conv":
                out[".".join(prefix + ("conv", "weight"))] = np.transpose(
                    np.asarray(v["kernel"], np.float32), (3, 2, 0, 1))
            else:
                out[".".join(prefix + (names[k],))] = np.asarray(v, np.float32)
                if k == "bn_scale":
                    out[".".join(prefix + ("bn", "num_batches_tracked"))] = np.asarray(0)

    walk(variables.get("params", variables), ())
    return out
