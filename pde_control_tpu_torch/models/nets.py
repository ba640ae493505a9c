"""Networks for PDE control, 2D: the CFE conv net and the OP U-net.

Counterpart of `pde_control_tpu/models/nets.py` (`Conv`, `ConvBlock`,
`UNet`, `CFENet`) at dim=2. Inputs and outputs are channels-last
(B, H, W, C) at the public boundary, as in the JAX package; inside, the
nets run NCHW through `torch.nn.functional.conv2d`. Parameters are fp32;
compute runs in `dtype` (bf16 on the main path), as flax's `dtype`
attribute does.

Submodules carry flax's auto-names (`Conv_0`, `ConvBlock_3.Conv_1`, …), so
converting the JAX package's weights is a rename and a transpose
(`utils/convert.py`).

Padding is flax's 'SAME': for a stride-2 conv on an even input that is
(0, 1) — one cell after, none before — which `Conv2d(padding=1)` would
get wrong, so uneven padding goes through `F.pad`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """(before, after) padding of XLA's 'SAME' along one axis."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator | None) -> None:
    """flax's default kernel init: truncated normal on [-2σ, 2σ] with
    variance 1/fan_in after truncation."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv(nn.Module):
    """k×k conv with 'SAME' padding; channels-first inside the nets."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dtype=torch.float32, zero_init: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel_size, self.stride, self.dtype = kernel_size, stride, dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))
        with torch.no_grad():
            if zero_init:
                self.weight.zero_()
            else:
                _lecun_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size, self.stride
        top, bottom = _same_pads(x.shape[-2], k, s)
        left, right = _same_pads(x.shape[-1], k, s)
        x = x.to(self.dtype)
        if top == bottom and left == right:
            pad = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            pad = 0
        return F.conv2d(x, self.weight.to(self.dtype), self.bias.to(self.dtype),
                        stride=s, padding=pad)


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class ConvBlock(nn.Module):
    def __init__(self, in_features: int, features: int, dtype=torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, dtype=dtype, generator=generator)
        self.Conv_1 = Conv(features, features, dtype=dtype, generator=generator)

    def forward(self, x):
        return _leaky_relu(self.Conv_1(_leaky_relu(self.Conv_0(x))))


class _FlaxNamed(nn.Module):
    """Registers submodules under flax's per-class auto-names; the nets
    keep the names in the order their forward pass uses them."""

    def __init__(self):
        super().__init__()
        self._counts: dict[str, int] = {}

    def _add(self, module: nn.Module) -> str:
        kind = type(module).__name__
        n = self._counts.get(kind, 0)
        self._counts[kind] = n + 1
        name = f"{kind}_{n}"
        self.add_module(name, module)
        return name


class UNet(_FlaxNamed):
    """Multi-scale encoder-decoder with skip connections (the OP net).

    `levels` stride-2 downsampling stages; spatial dims must be divisible
    by 2**levels. Input/output are channels-last: (B, H, W, C).
    """

    def __init__(self, in_channels: int, out_channels: int, levels: int = 3,
                 base_features: int = 16, dtype=torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.encoder = []
        cin, feats = in_channels, base_features
        for _ in range(levels):
            block = self._add(ConvBlock(cin, feats, **kw))
            down = self._add(Conv(feats, feats * 2, stride=2, **kw))
            self.encoder.append((block, down))
            cin, feats = feats * 2, feats * 2
        self.bottom = self._add(ConvBlock(cin, feats, **kw))
        self.decoder = []
        for _ in range(levels):
            feats //= 2
            up = self._add(Conv(feats * 2, feats, **kw))
            block = self._add(ConvBlock(feats * 2, feats, **kw))
            self.decoder.append((up, block))
        self.out = self._add(Conv(feats, out_channels, kernel_size=1, **kw))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        skips = []
        for block, down in self.encoder:
            x = self.get_submodule(block)(x)
            skips.append(x)
            x = self.get_submodule(down)(x)
        x = self.get_submodule(self.bottom)(x)
        for (up, block), skip in zip(self.decoder, reversed(skips)):
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            x = self.get_submodule(up)(x)
            x = self.get_submodule(block)(torch.cat([x, skip], dim=1))
        return self.get_submodule(self.out)(x).permute(0, 2, 3, 1).to(in_dtype)


class CFENet(_FlaxNamed):
    """Control-force estimator: a small conv net.

    The output layer is zero-initialised: an untrained CFE exerts no force,
    so rollouts start at the natural (uncontrolled) trajectory.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 features: Sequence[int] = (32, 64, 64, 32),
                 dtype=torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = []
        cin = in_channels
        for f in features:
            self.hidden.append(self._add(
                Conv(cin, f, dtype=dtype, generator=generator)))
            cin = f
        self.out = self._add(Conv(cin, out_channels, dtype=dtype, zero_init=True))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for name in self.hidden:
            x = _leaky_relu(self.get_submodule(name)(x))
        return self.get_submodule(self.out)(x).permute(0, 2, 3, 1).to(in_dtype)
