"""Networks for PDE control, 2D: the CFE conv net and the OP U-net.

Counterpart of `pde_control_tpu/models/nets.py` (`Conv`, `ConvBlock`,
`UNet`, `CFENet`) at dim=2. Inputs and outputs are channels-last
(B, H, W, C) at the public boundary, as in the JAX package. Parameters are
fp32; compute runs in `dtype` (bf16 on the main path), as flax's `dtype`
attribute does.

`conv_impl` picks the convolution, as in the JAX package:
  * 'xla' and 'auto': `torch.nn.functional.conv2d` (cuDNN on the card);
    the nets run NCHW inside. 'auto' stays here until a benchmark routes
    it from measurements on the card.
  * 'cuda': every 3×3 stride-1 SAME conv goes to the hand-written kernels
    of `ops/cuda_conv.py` (JAX's 'pallas'); the stride-2 downsampling convs
    and the U-net's 1×1 output conv stay on `conv2d`. The nets run
    channels-last inside, the kernels' layout, so the eligible convs need
    no permute and the others see a channels-last view.
'pallas' raises and names 'cuda'. JAX's XLA reformulations 'patches',
'shifted' and 'im2col' are not ported (ROADMAP queue A) and raise.

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

from pde_control_tpu_torch.ops import cuda_conv

CONV_IMPLS = ("xla", "auto", "cuda")


def _check_conv_impl(conv_impl: str) -> None:
    if conv_impl == "pallas":
        raise ValueError("conv_impl='pallas' is the JAX package's name; the "
                         "port's hand-written conv kernels are conv_impl='cuda'")
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"conv_impl {conv_impl!r} is not ported; choose from "
                         f"{CONV_IMPLS}")


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
    """k×k conv with 'SAME' padding. It takes and returns (B, C, H, W), or
    (B, H, W, C) under conv_impl='cuda'."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dtype=torch.float32, zero_init: bool = False,
                 generator: torch.Generator | None = None,
                 conv_impl: str = "xla"):
        super().__init__()
        _check_conv_impl(conv_impl)
        self.kernel_size, self.stride, self.dtype = kernel_size, stride, dtype
        self.conv_impl = conv_impl
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))
        with torch.no_grad():
            if zero_init:
                self.weight.zero_()
            else:
                _lecun_normal_(self.weight, generator)

    def _shape_eligible(self, x: torch.Tensor) -> bool:
        """The JAX package's gate: 2D, 3×3, stride 1 (SAME padding, no
        dilation and no groups hold for every conv of the nets)."""
        return x.dim() == 4 and self.kernel_size == 3 and self.stride == 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv_impl != "cuda":
            return self._conv2d(x)
        if self._shape_eligible(x):
            return cuda_conv.conv3x3(x, self.weight.permute(2, 3, 1, 0),
                                     self.bias, dtype=self.dtype)
        return self._conv2d(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def _conv2d(self, x: torch.Tensor) -> torch.Tensor:
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
                 generator: torch.Generator | None = None,
                 conv_impl: str = "xla"):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, conv_impl=conv_impl)
        self.Conv_0 = Conv(in_features, features, **kw)
        self.Conv_1 = Conv(features, features, **kw)

    def forward(self, x):
        return _leaky_relu(self.Conv_1(_leaky_relu(self.Conv_0(x))))


class _FlaxNamed(nn.Module):
    """Registers submodules under flax's per-class auto-names; the nets
    keep the names in the order their forward pass uses them. Also the
    layout inside the net: channels-last under conv_impl='cuda', NCHW
    otherwise."""

    def __init__(self, dtype, conv_impl: str):
        super().__init__()
        self._counts: dict[str, int] = {}
        self.dtype = dtype
        self.channels_last = conv_impl == "cuda"
        # The channel axis and the two spatial axes inside the net.
        self._c, self._hw = (3, (1, 2)) if self.channels_last else (1, (2, 3))

    def _enter(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return x if self.channels_last else x.permute(0, 3, 1, 2)

    def _leave(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return (x if self.channels_last else x.permute(0, 2, 3, 1)).to(dtype)

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
                 generator: torch.Generator | None = None,
                 conv_impl: str = "xla"):
        super().__init__(dtype, conv_impl)
        kw = dict(dtype=dtype, generator=generator, conv_impl=conv_impl)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        x = self._enter(x)
        skips = []
        for block, down in self.encoder:
            x = self.get_submodule(block)(x)
            skips.append(x)
            x = self.get_submodule(down)(x)
        x = self.get_submodule(self.bottom)(x)
        sy, sx = self._hw
        for (up, block), skip in zip(self.decoder, reversed(skips)):
            x = x.repeat_interleave(2, dim=sy).repeat_interleave(2, dim=sx)
            x = self.get_submodule(up)(x)
            x = self.get_submodule(block)(torch.cat([x, skip], dim=self._c))
        return self._leave(self.get_submodule(self.out)(x), in_dtype)


class CFENet(_FlaxNamed):
    """Control-force estimator: a small conv net.

    The output layer is zero-initialised: an untrained CFE exerts no force,
    so rollouts start at the natural (uncontrolled) trajectory.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 features: Sequence[int] = (32, 64, 64, 32),
                 dtype=torch.float32, generator: torch.Generator | None = None,
                 conv_impl: str = "xla"):
        super().__init__(dtype, conv_impl)
        self.hidden = []
        cin = in_channels
        for f in features:
            self.hidden.append(self._add(Conv(
                cin, f, dtype=dtype, generator=generator, conv_impl=conv_impl)))
            cin = f
        self.out = self._add(Conv(cin, out_channels, dtype=dtype, zero_init=True,
                                  conv_impl=conv_impl))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        x = self._enter(x)
        for name in self.hidden:
            x = _leaky_relu(self.get_submodule(name)(x))
        return self._leave(self.get_submodule(self.out)(x), in_dtype)
