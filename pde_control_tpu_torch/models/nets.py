"""Networks for PDE control: the CFE conv net and the OP U-net, 1D, 2D and
3D.

Counterpart of `pde_control_tpu/models/nets.py` (`Conv`, `ConvBlock`,
`UNet`, `CFENet`) at dim=1 (Burgers), dim=2 and dim=3 (the 3D smoke
task). Inputs and outputs are
channels-last (B, *spatial, C) at the public boundary, as in the JAX
package. Parameters are fp32; compute runs in `dtype` (bf16 on the 2D main
path, fp32 for Burgers), as flax's `dtype` attribute does.

`conv_impl` picks the convolution, as in the JAX package:
  * 'xla' and 'auto': `torch.nn.functional.conv1d`/`conv2d`/`conv3d`
    (cuDNN on the card); the nets run channels-first inside. 'auto' stays here until a
    benchmark routes it from measurements on the card.
  * 'cuda': every 2D 3×3 stride-1 SAME conv goes to the hand-written
    kernels of `ops/cuda_conv.py` (JAX's 'pallas'); the stride-2
    downsampling convs and the U-net's 1×1 output conv stay on `conv2d`.
    The 2D nets run channels-last inside, the kernels' layout, so the
    eligible convs need no permute and the others see a channels-last
    view. 1D and 3D convs stay on `conv1d`/`conv3d` and channels-first,
    as the JAX package's stay on XLA (its kernel gate needs a 4-D input).
  * 'patches', 'shifted' and 'im2col': the JAX package's reformulations
    of a 3×3 stride-1 SAME conv as plain matmuls (`Conv._patches_call`,
    `_shifted_call` there), which run outside any kernel there too:
    'patches' is `F.unfold` and one matmul over the channel-major
    (Cin, ky, kx) features; 'shifted' sums nine (Cin, Cout) products, one
    per statically shifted view of the zero-padded input; 'im2col'
    concatenates the nine views (tap-major) and runs one matmul. The
    operands are rounded to `dtype` and multiplied in fp32, the bias added
    in fp32 and the sum rounded to `dtype` once, as the JAX package's
    dots with an fp32 result do. Every other conv (stride 2, 1×1,
    CIRCULAR, 1D, 3D) takes `conv1d`/`conv2d`/`conv3d`, as there. The nets stay
    channels-first inside.
'pallas' raises and names 'cuda'.

Submodules carry flax's auto-names (`Conv_0`, `ConvBlock_3.Conv_1`, …), so
converting the JAX package's weights is a rename and a transpose
(`utils/convert.py`).

Padding is flax's:
  * 'SAME': for a stride-2 conv on an even input that is (0, 1) along
    each axis — one cell after, none before — which `Conv2d(padding=1)`
    or `Conv3d(padding=1)` would get wrong, so uneven padding goes through
    `F.pad`;
  * 'CIRCULAR' (periodic Burgers): ((k-1)//2, k//2) cells by wrap, then a
    VALID conv, whatever the stride. It is not SAME with wrap: a stride-2
    conv on even N reads cells 2i-1, 2i, 2i+1 (SAME reads 2i, 2i+1,
    2i+2).
The U-net's 1×1 output conv keeps 'SAME', as flax's default.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from pde_control_tpu_torch.ops import cuda_conv

CONV_IMPLS = ("xla", "auto", "cuda", "patches", "shifted", "im2col")
PADDINGS = ("SAME", "CIRCULAR")
_CONVS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _check_conv_impl(conv_impl: str) -> None:
    if conv_impl == "pallas":
        raise ValueError("conv_impl='pallas' is the JAX package's name; the "
                         "port's hand-written conv kernels are conv_impl='cuda'")
    if conv_impl not in CONV_IMPLS:
        raise ValueError(f"unknown conv_impl {conv_impl!r}; choose from "
                         f"{CONV_IMPLS}")


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """(before, after) padding of XLA's 'SAME' along one axis."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator | None) -> None:
    """flax's default kernel init: truncated normal on [-2σ, 2σ] with
    variance 1/fan_in after truncation."""
    fan_in = math.prod(w.shape[1:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv(nn.Module):
    """k^dim conv with flax's 'SAME' or 'CIRCULAR' padding. It takes and
    returns (B, C, *spatial), or (B, H, W, C) for a 2D conv under
    conv_impl='cuda'."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, dtype=torch.float32, zero_init: bool = False,
                 generator: torch.Generator | None = None,
                 conv_impl: str = "xla", dim: int = 2,
                 padding: str = "SAME"):
        super().__init__()
        _check_conv_impl(conv_impl)
        if dim not in _CONVS:
            raise ValueError(f"dim={dim} is not ported (1, 2 or 3)")
        if padding not in PADDINGS:
            raise ValueError(f"padding {padding!r} is not ported; choose "
                             f"from {PADDINGS}")
        self.kernel_size, self.stride, self.dtype = kernel_size, stride, dtype
        self.conv_impl, self.dim, self.padding = conv_impl, dim, padding
        self.channels_last = conv_impl == "cuda" and dim == 2
        self.weight = nn.Parameter(
            torch.empty(features, in_features, *(kernel_size,) * dim))
        self.bias = nn.Parameter(torch.zeros(features))
        with torch.no_grad():
            if zero_init:
                self.weight.zero_()
            else:
                _lecun_normal_(self.weight, generator)

    def _shape_eligible(self, x: torch.Tensor) -> bool:
        """The JAX package's gate: 2D, 3×3, stride 1, SAME (no dilation
        and no groups hold for every conv of the nets)."""
        return (x.dim() == 4 and self.kernel_size == 3 and self.stride == 1
                and self.padding == "SAME")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv_impl in _MATMUL_IMPLS and self._shape_eligible(x):
            # The JAX package's dots take `dtype` operands and return fp32
            # (preferred_element_type), add the fp32 bias, then cast: fp32
            # products of the rounded operands are its fp32 sums.
            return _MATMUL_IMPLS[self.conv_impl](
                x.to(self.dtype).float(), self.weight.to(self.dtype).float(),
                self.bias.float()).to(self.dtype)
        if not self.channels_last:
            return self._conv(x)
        if self._shape_eligible(x):
            return cuda_conv.conv3x3(x, self.weight.permute(2, 3, 1, 0),
                                     self.bias, dtype=self.dtype)
        return self._conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size, self.stride
        if self.padding == "CIRCULAR":
            pads, mode = [((k - 1) // 2, k // 2)] * self.dim, "circular"
        else:
            pads, mode = [_same_pads(n, k, s) for n in x.shape[2:]], "constant"
        x = x.to(self.dtype)
        if mode == "constant" and all(a == b for a, b in pads):
            pad = tuple(a for a, _ in pads)
        else:
            flat = [p for pair in reversed(pads) for p in pair]
            if any(flat):
                x = F.pad(x, flat, mode=mode)
            pad = 0
        return _CONVS[self.dim](x, self.weight.to(self.dtype),
                                self.bias.to(self.dtype), stride=s,
                                padding=pad)


def _taps(x: torch.Tensor) -> list[torch.Tensor]:
    """The nine views of the zero-padded (B, C, H, W) input that a 3×3 SAME
    conv reads, in (ky, kx) order."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1))
    return [xp[:, :, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]


def _patches_conv(x, weight, bias):
    """'patches': unfold (channel-major (Cin, ky, kx) features, the order of
    `weight.reshape(Cout, 9·Cin)`) and one matmul."""
    b, _, h, w = x.shape
    cols = F.unfold(x, 3, padding=1)                    # (B, 9·Cin, H·W)
    y = torch.matmul(weight.reshape(weight.shape[0], -1), cols)
    return (y + bias[:, None]).reshape(b, -1, h, w)


def _shifted_conv(x, weight, bias):
    """'shifted': one (Cin, Cout) product per tap, summed."""
    y = None
    for t, tap in enumerate(_taps(x)):
        p = torch.einsum("bchw,oc->bohw", tap, weight[:, :, t // 3, t % 3])
        y = p if y is None else y + p
    return y + bias[:, None, None]


def _im2col_conv(x, weight, bias):
    """'im2col': the nine views concatenated tap-major and one matmul."""
    cols = torch.cat(_taps(x), dim=1)                   # (B, 9·Cin, H, W)
    wflat = weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1)
    return torch.einsum("bkhw,ok->bohw", cols, wflat) + bias[:, None, None]


_MATMUL_IMPLS = {"patches": _patches_conv, "shifted": _shifted_conv,
                 "im2col": _im2col_conv}


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class ConvBlock(nn.Module):
    def __init__(self, in_features: int, features: int, dtype=torch.float32,
                 generator: torch.Generator | None = None,
                 conv_impl: str = "xla", dim: int = 2, padding: str = "SAME"):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator, conv_impl=conv_impl,
                  dim=dim, padding=padding)
        self.Conv_0 = Conv(in_features, features, **kw)
        self.Conv_1 = Conv(features, features, **kw)

    def forward(self, x):
        return _leaky_relu(self.Conv_1(_leaky_relu(self.Conv_0(x))))


class _FlaxNamed(nn.Module):
    """Registers submodules under flax's per-class auto-names; the nets
    keep the names in the order their forward pass uses them. Also the
    layout inside the net: channels-last for a 2D net under
    conv_impl='cuda', channels-first otherwise."""

    def __init__(self, dtype, conv_impl: str, dim: int):
        super().__init__()
        self._counts: dict[str, int] = {}
        self.dtype = dtype
        self.channels_last = conv_impl == "cuda" and dim == 2
        # The channel axis and the spatial axes inside the net.
        self._c = dim + 1 if self.channels_last else 1
        first = 1 if self.channels_last else 2
        self._spatial = tuple(range(first, first + dim))

    def _enter(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return x if self.channels_last else x.movedim(-1, 1)

    def _leave(self, x: torch.Tensor, dtype) -> torch.Tensor:
        return (x if self.channels_last else x.movedim(1, -1)).to(dtype)

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
    by 2**levels. Input/output are channels-last: (B, *spatial, C).
    """

    def __init__(self, in_channels: int, out_channels: int, levels: int = 3,
                 base_features: int = 16, dtype=torch.float32,
                 generator: torch.Generator | None = None,
                 conv_impl: str = "xla", dim: int = 2, padding: str = "SAME"):
        super().__init__(dtype, conv_impl, dim)
        kw = dict(dtype=dtype, generator=generator, conv_impl=conv_impl,
                  dim=dim)
        pkw = dict(kw, padding=padding)
        self.encoder = []
        cin, feats = in_channels, base_features
        for _ in range(levels):
            block = self._add(ConvBlock(cin, feats, **pkw))
            down = self._add(Conv(feats, feats * 2, stride=2, **pkw))
            self.encoder.append((block, down))
            cin, feats = feats * 2, feats * 2
        self.bottom = self._add(ConvBlock(cin, feats, **pkw))
        self.decoder = []
        for _ in range(levels):
            feats //= 2
            up = self._add(Conv(feats * 2, feats, **pkw))
            block = self._add(ConvBlock(feats * 2, feats, **pkw))
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
        for (up, block), skip in zip(self.decoder, reversed(skips)):
            for ax in self._spatial:  # nearest-neighbour 2x upsampling
                x = x.repeat_interleave(2, dim=ax)
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
                 conv_impl: str = "xla", dim: int = 2, padding: str = "SAME"):
        super().__init__(dtype, conv_impl, dim)
        kw = dict(dtype=dtype, conv_impl=conv_impl, dim=dim, padding=padding)
        self.hidden = []
        cin = in_channels
        for f in features:
            self.hidden.append(self._add(Conv(cin, f, generator=generator,
                                              **kw)))
            cin = f
        self.out = self._add(Conv(cin, out_channels, zero_init=True, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        x = self._enter(x)
        for name in self.hidden:
            x = _leaky_relu(self.get_submodule(name)(x))
        return self._leave(self.get_submodule(self.out)(x), in_dtype)
