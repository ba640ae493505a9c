"""3×3 SAME stride-1 convolution, channels-last: the Hopper kernels
(`csrc/conv3x3.cu`) and their plain PyTorch versions.

Counterpart of `pde_control_tpu/ops/pallas_conv.py`. Replaces its TPU
kernels `_make_conv._run_fwd` (K4, body `_fwd_kernel`: y = im2col(x) @ W
+ b, and the same kernel on the cotangent with the rotated, io-transposed
weights for dX) and `_make_conv.bwd`'s dW (K5, body `_dw_kernel`: dW =
Σ over batch and pixels of im2col(x)ᵀ·dY). The kernels are implicit GEMMs
on the bf16 tensor cores with fp32 accumulators; im2col is never built.

Neither kernel is bound on this card by its bytes or its operations but
by latency (blocks that wait for loads between a few products), by x read
once per tap, and on the 8²–16² layers by too few blocks for 132 SMs. Both
answer it the same way: a block stages the halo tile of the pixels it
owns once per slice of channels, by `cp.async` through a ring of two
buffers, and reads all nine taps' operands from that one tile at constant
pixel offsets (`ldmatrix` + `mma.sync`). Where too few blocks would run,
S blocks sum disjoint parts of the reduction into their own fp32 partials
and a second pass adds the partials in a fixed order and rounds once, so
results are the same in every run.
- K4: a block owns a run of output positions in a padded index space that
  stacks the batch's images (whole rows of the image, or of a segment of
  its columns for an image too wide for shared memory), one tile of output
  channels, and a run of the 16-channel slices of K (`fwd_plan`). dX reads
  the forward weights rotated by index while it stages them.
- K5: a block owns runs of whole image rows of one sample and stages each
  run's x halo tile and dY tile (`dw_plan`); with S = 1 the first pass
  rounds and writes dW itself.

Rounding points, as in the JAX package: x and W in the compute dtype
before the product, the bias rounded to it, fp32 sums, and y, dX and dW
rounded once at the end; db = ΣdY in fp32, rounded once.

`conv3x3` is the public, differentiable function (the JAX package's
signature and layout: x (B, H, W, Cin), kernel (3, 3, Cin, Cout)). The
three directions, `conv3x3_forward` (K4), `conv3x3_dx` (K4 on the rotated
weights) and `conv3x3_dw` (K5), launch their kernel for CUDA tensors and
run the plain versions below for CPU tensors; a CUDA tensor they cannot
take (a dtype other than bf16, a shape or layout they do not take) raises.
`LAUNCHES_FWD`, `LAUNCHES_DX` and `LAUNCHES_DW` count the launches.

K4 has no fit gate: an image too wide for shared memory is cut into
segments of columns. K5 holds whole rows, so an image too wide for a run
of one row in shared memory (W in the thousands) raises. B·H·W ≥ 2³¹
raises in both (int32 pixel indexing).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from pde_control_tpu_torch.ops import cuda_cg

#: Launches of K4 forward, K4 for dX and K5 since import, or since a caller
#: reset them.
LAUNCHES_FWD = 0
LAUNCHES_DX = 0
LAUNCHES_DW = 0

#: The most dynamic shared memory one block may ask for on this card.
MAX_SHARED_BYTES = 232448
_SMS = 132  # the H100's streaming multiprocessors
#: The dynamic shared memory of each of two blocks on one SM (228 KB an SM,
#: 1 KB of it reserved per block).
_TWO_PER_SM_BYTES = 233472 // 2 - 1024


# --------------------------------------------------------------------------
# Plain versions: the im2col matmul with the kernels' rounding points.
# --------------------------------------------------------------------------


def _im2col(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → (B·H·W, 9C) in fp32; taps (dy, dx) row-major, the
    order of the (3, 3, C, Co) → (9C, Co) weight reshape."""
    b, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    taps = [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)]
    return torch.cat(taps, dim=-1).reshape(b * h * w, 9 * c)


def conv3x3_plain(x: torch.Tensor, wflat: torch.Tensor,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """K4's plain version: im2col(x) @ wflat (+ bias) summed in fp32 and
    rounded to x's dtype. x (B, H, W, Cin), wflat (9·Cin, Cout), bias
    (Cout,), all in the compute dtype."""
    b, h, w, _ = x.shape
    acc = _im2col(x) @ wflat.float()
    if bias is not None:
        acc = acc + bias.float()
    return acc.reshape(b, h, w, -1).to(x.dtype)


def rotate_weights(wflat: torch.Tensor) -> torch.Tensor:
    """(9·Cin, Cout) → (9·Cout, Cin): the window turned 180° with in and out
    channels swapped (the JAX package's `wback`)."""
    cin, cout = wflat.shape[0] // 9, wflat.shape[1]
    return (wflat.reshape(3, 3, cin, cout).flip(0, 1).transpose(2, 3)
            .reshape(9 * cout, cin))


def conv3x3_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5's plain version: im2col(x)ᵀ @ dY over every pixel of the batch in
    fp32, rounded once to x's dtype."""
    return (_im2col(x).T @ g.reshape(-1, g.shape[-1]).float()).to(x.dtype)


# --------------------------------------------------------------------------
# The kernels' wrappers.
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _kernels():
    from pde_control_tpu_torch.ops._build import load

    lib, _ = load()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fwd = lib.conv3x3_fwd_bf16
    fwd.argtypes = [ptr] * 5 + [i32] * 12 + [ptr]
    fwd.restype = i32
    dw = lib.conv3x3_dw_bf16
    dw.argtypes = [ptr] * 4 + [i32] * 10 + [ptr]
    dw.restype = i32
    return fwd, dw


class FwdPlan(NamedTuple):
    """How K4's first pass cuts its work: output channels in tiles of `bn`,
    output positions in tiles of 128·`fm` (eight warps of `fm` 16-position
    fragments), columns in segments of `seg` (all of W where it fits), and
    the 16-channel slices of K into `splits` runs, each summed into its own
    fp32 partial and added by a second pass when there is more than one."""
    bn: int
    fm: int
    seg: int
    splits: int
    blocks: int          # blocks of the first pass
    shared_bytes: int    # dynamic shared memory of one block
    partial_bytes: int   # fp32 partials written and read again; 0 at S = 1


#: K4's instantiations: (output-channel tile, 16-position fragments per
#: warp), at most 64 fp32 sums per thread. A 64-channel tile was faster
#: at no shape of the training iteration (`sweep_dw_plan.py fwd` on an
#: H100) and spilled at two fragments; 64 output channels are two
#: 32-channel tiles.
FWD_TILES = tuple((bn, fm) for bn in (16, 32) for fm in (1, 2, 4))


def _fwd_wp(seg: int, w: int) -> int:
    """The padded width: one halo column where one segment holds all of W
    (the right halo of a row is the left halo of the next), else two."""
    return seg + 1 if seg >= w else seg + 2


def fwd_shared_bytes(bn: int, fm: int, seg: int, w: int) -> int:
    """The dynamic shared memory K4's first pass asks for
    (`conv3x3_fwd_shared_bytes` in C): two buffers, each the halo tile of
    128·fm + 2·wp + 2 padded pixels by 16 + 8 channels and the nine taps'
    weights of one 16-channel slice, 16 × (bn + 8) or bn × (16 + 8)
    values, whichever is more, in bf16."""
    halo = 128 * fm + 2 * _fwd_wp(seg, w) + 2
    return 2 * 2 * (halo * 24 + 9 * max(16 * (bn + 8), bn * 24))


def _fwd_blocks(b: int, h: int, w: int, cout: int, bn: int, fm: int,
                seg: int) -> int:
    """Blocks of one split: tiles of the padded positions (the batch's
    b·(h + 1) rows of wp after a zero row) in each segment, by output
    channel tiles."""
    positions = (b * (h + 1) - 1) * _fwd_wp(seg, w)
    return -(-positions // (128 * fm)) * -(-w // seg) * -(-cout // bn)


@functools.lru_cache(maxsize=256)  # a net asks for the same few shapes
def fwd_plan(b: int, h: int, w: int, cin: int, cout: int) -> FwdPlan:
    """K4's plan for x (b, h, w, cin) → y (b, h, w, cout); dX asks with
    dY's channels as cin and dX's as cout. The output channel tile is 16
    where that covers cout, else 32. The segment is all of W where
    the ring leaves room for two blocks an SM (the registers allow two),
    else W halved until it does. Positions per tile: the most that still
    gives two blocks per SM, else 128. Splits: where one split's blocks
    fall short of one per SM, enough runs of the slices of K to make up
    one per SM, as far as the slices go."""
    bn = 16 if cout <= 16 else 32
    chosen = None
    for fm in (fm for tile, fm in FWD_TILES if tile == bn):
        seg = w
        while seg > 1 and fwd_shared_bytes(bn, fm, seg, w) > _TWO_PER_SM_BYTES:
            seg = -(-seg // 2)
        blocks = _fwd_blocks(b, h, w, cout, bn, fm, seg)
        if chosen is None or blocks >= 2 * _SMS:
            chosen = fm, seg, blocks
    fm, seg, blocks = chosen
    slices = -(-cin // 16)
    per_split = -(-slices // min(slices, -(-_SMS // blocks)))
    return _fwd_plan(b, h, w, cout, bn, fm, seg, -(-slices // per_split))


def _fwd_plan(b: int, h: int, w: int, cout: int, bn: int, fm: int, seg: int,
              splits: int) -> FwdPlan:
    return FwdPlan(bn, fm, seg, splits, _fwd_blocks(b, h, w, cout, bn, fm, seg),
                   fwd_shared_bytes(bn, fm, seg, w),
                   splits * 4 * b * h * w * cout if splits > 1 else 0)


def fwd_plans(b: int, h: int, w: int, cin: int, cout: int) -> list[FwdPlan]:
    """Every plan K4's launcher takes for x (b, h, w, cin) → (b, h, w,
    cout): each tile of `FWD_TILES` with the widest segment whose ring fits
    a block's shared memory, by each distinct number of splits of the
    16-channel slices of K. `fwd_plan` picks one of them or one with a
    narrower segment."""
    slices = -(-cin // 16)
    plans = []
    for bn, fm in FWD_TILES:
        seg = w
        while seg > 1 and fwd_shared_bytes(bn, fm, seg, w) > MAX_SHARED_BYTES:
            seg = -(-seg // 2)
        plans += [_fwd_plan(b, h, w, cout, bn, fm, seg, splits) for splits in
                  sorted({-(-slices // p) for p in range(1, slices + 1)})]
    return plans


class DwPlan(NamedTuple):
    """How K5's first pass cuts the batch: runs of `rows` image rows of one
    sample (the last run of a sample may be shorter), `runs_per_block`
    consecutive runs per block, `splits` blocks per (channel tile, Cout
    tile), each with its own fp32 slice of the partial sums."""
    rows: int
    runs_per_block: int
    splits: int
    shared_bytes: int    # dynamic shared memory of one block
    partial_bytes: int   # fp32 partials written and read again; 0 at S = 1


def _dw_tile(cin: int, cout: int) -> tuple[int, int]:
    """K5's (channel tile, Cout tile): all of Cin up to 16, else 32 at a
    time, by the least of 16, 32 and 64 that covers Cout (`dw_frags_c` and
    `tile_n` in C)."""
    return 16 if cin <= 16 else 32, 16 if cout <= 16 else 32 if cout <= 32 else 64


def dw_shared_bytes(rows: int, w: int, cin: int, cout: int) -> int:
    """The dynamic shared memory K5's first pass asks for
    (`conv3x3_dw_shared_bytes` in C): two buffers, each the x halo tile of
    (rows + 2)·(W + 2) pixels and 24 zero pixels after it by the channel
    tile + 8, and the padded dY tile of rows·(W + 2) pixels, rounded up to
    16, by the Cout tile + 8, in bf16; or the fp32 sums that the warps
    sharing one fragment pair hand over at the end, where that is more."""
    ct, bn = _dw_tile(cin, cout)
    wp = w + 2
    ring = 2 * 2 * (((rows + 2) * wp + 24) * (ct + 8)
                    + -(-rows * wp // 16) * 16 * (bn + 8))
    pairs = (ct // 16) * (bn // 16)
    return max(ring, 4 * (8 - pairs) * 72 * 32)


@functools.lru_cache(maxsize=256)  # a net asks for the same few shapes
def dw_plan(b: int, h: int, w: int, cin: int, cout: int) -> DwPlan:
    """K5's plan for x (b, h, w, cin) and dY (b, h, w, cout), tuned on one
    H100 at the 64², n=16 training iteration's shapes. Blocks: one wave, one
    block per SM over the (channel tile, Cout tile) pairs; more splits cost
    more in partials, S·9·Cin·Cout·4 bytes written and read again, than
    they win. Rows per run: a block's share of the batch's rows in one run
    where the ring fits the card's shared memory, else in two or more; at
    least 64 padded pixels (four fragments), in runs of equal length, and
    never past a sample's last row. An image too wide for a run of one row
    raises."""
    ct, bn = _dw_tile(cin, cout)
    tiles = -(-cin // ct) * -(-cout // bn)
    target = max(1, _SMS // tiles)
    wanted = max(-(-b * h // target), -(-64 // (w + 2)))
    rows = -(-h // max(1, h // wanted))
    while rows > 1 and dw_shared_bytes(rows, w, cin, cout) > MAX_SHARED_BYTES:
        rows = -(-rows // 2)
    shared = dw_shared_bytes(rows, w, cin, cout)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"conv3x3_dw: one row of {w} pixels needs {shared} "
                         f"bytes of shared memory, above {MAX_SHARED_BYTES}")
    total_runs = b * -(-h // rows)
    return _dw_plan(b, h, cin, cout, rows, -(-total_runs // target), shared)


def _dw_plan(b: int, h: int, cin: int, cout: int, rows: int,
             runs_per_block: int, shared: int) -> DwPlan:
    splits = -(-(b * -(-h // rows)) // runs_per_block)
    return DwPlan(rows, runs_per_block, splits, shared,
                  splits * 4 * 9 * cin * cout if splits > 1 else 0)


def dw_plans(b: int, h: int, w: int, cin: int, cout: int) -> list[DwPlan]:
    """Every plan K5's launcher takes for x (b, h, w, cin) and dY (b, h, w,
    cout): runs of 1, 2, 4, … rows up to H whose ring fits a block's shared
    memory, each with one plan for each distinct number of splits that a
    power-of-two count of blocks gives."""
    plans = {}
    for rows in (2 ** i for i in range(h.bit_length())):
        shared = dw_shared_bytes(rows, w, cin, cout)
        if shared > MAX_SHARED_BYTES:
            continue
        total_runs = b * -(-h // rows)
        for target in (2 ** i for i in range(total_runs.bit_length())):
            plan = _dw_plan(b, h, cin, cout, rows, -(-total_runs // target),
                            shared)
            plans.setdefault((rows, plan.splits), plan)
    return list(plans.values())


def _vec(t: torch.Tensor, channels: int) -> int:
    """Whether the kernel may load `t` 16 bytes (8 channels) at a time."""
    return int(channels % 8 == 0 and t.data_ptr() % 16 == 0)


def _check_image(name: str, t: torch.Tensor) -> tuple[int, int, int, int]:
    if t.dim() != 4:
        raise ValueError(f"{name}: want (B, H, W, C), got {tuple(t.shape)}")
    cuda_cg._check(name, t, tuple(t.shape), t.device, torch.bfloat16)
    b, h, w, c = t.shape
    if b * h * w >= 2**31:
        raise ValueError(f"{name}: {b * h * w} pixels exceed the kernels' int32 "
                         "pixel index")
    return b, h, w, c


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd_launch(name: str, x: torch.Tensor, wgt: torch.Tensor,
                bias: torch.Tensor | None, cin: int, cout: int,
                rotated: bool, plan: FwdPlan | None = None) -> torch.Tensor:
    """K4 on x (B, H, W, cin) → (B, H, W, cout) under `plan` (None:
    `fwd_plan`'s; the tests pass the others of `fwd_plans`)."""
    b, h, w, _ = x.shape
    if plan is None:
        plan = fwd_plan(b, h, w, cin, cout)
    partial = (torch.empty((plan.splits, b * h * w, cout), dtype=torch.float32,
                           device=x.device) if plan.splits > 1 else None)
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    rc = _kernels()[0](x.data_ptr(), wgt.data_ptr(),
                       None if bias is None else bias.data_ptr(), y.data_ptr(),
                       None if partial is None else partial.data_ptr(),
                       b, h, w, cin, cout, int(rotated), plan.bn, plan.fm,
                       plan.seg, plan.splits, _vec(x, cin),
                       _vec(wgt, cin if rotated else cout), _stream(x))
    if rc != 0:
        raise RuntimeError(f"conv3x3_fwd_bf16 ({name}) launch failed with "
                           f"cudaError {rc}")
    return y


def conv3x3_forward(x: torch.Tensor, wflat: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """K4: y (B, H, W, Cout) = conv3x3(x, W) + bias for x (B, H, W, Cin),
    wflat (9·Cin, Cout) and bias (Cout,) or None, one dtype (bf16 on the
    card). The kernel adds the bias, rounded by the caller, to the fp32 sum
    and rounds y once."""
    global LAUNCHES_FWD
    if cuda_cg._runs_plain(x, "conv3x3_forward"):
        return conv3x3_plain(x, wflat, bias)
    _, _, _, cin = _check_image("x", x)
    cout = wflat.shape[-1]
    cuda_cg._check("wflat", wflat, (9 * cin, cout), x.device, torch.bfloat16)
    if bias is not None:
        cuda_cg._check("bias", bias, (cout,), x.device, torch.bfloat16)
    y = _fwd_launch("forward", x, wflat, bias, cin, cout, rotated=False)
    LAUNCHES_FWD += 1
    return y


def conv3x3_dx(g: torch.Tensor, wflat: torch.Tensor) -> torch.Tensor:
    """K4 for the input gradient: dX (B, H, W, Cin) = conv3x3(dY, W rotated
    180° and io-transposed), no bias, for dY (B, H, W, Cout) and the
    forward's wflat (9·Cin, Cout). The kernel reads wflat rotated by index
    as it stages it; no rotated copy is built."""
    global LAUNCHES_DX
    if cuda_cg._runs_plain(g, "conv3x3_dx"):
        return conv3x3_plain(g, rotate_weights(wflat))
    _, _, _, cout = _check_image("g", g)
    cin = wflat.shape[0] // 9
    cuda_cg._check("wflat", wflat, (9 * cin, cout), g.device, torch.bfloat16)
    dx = _fwd_launch("dX", g, wflat, None, cout, cin, rotated=True)
    LAUNCHES_DX += 1
    return dx


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K5: dW (9·Cin, Cout) = Σ over batch and pixels of im2col(x)ᵀ·dY for
    x (B, H, W, Cin) and dY (B, H, W, Cout), summed in fp32 and rounded
    once."""
    global LAUNCHES_DW
    if cuda_cg._runs_plain(x, "conv3x3_dw"):
        return conv3x3_dw_plain(x, g)
    b, h, w, cin = _check_image("x", x)
    cout = g.shape[-1]
    cuda_cg._check("g", g, (b, h, w, cout), x.device, torch.bfloat16)
    dw = _dw_launch(x, g, dw_plan(b, h, w, cin, cout))
    LAUNCHES_DW += 1
    return dw


def _dw_launch(x: torch.Tensor, g: torch.Tensor, plan: DwPlan) -> torch.Tensor:
    """K5 on checked operands under `plan` (the tests pass each of
    `dw_plans`)."""
    b, h, w, cin = x.shape
    cout = g.shape[-1]
    partial = (torch.empty((plan.splits, 9 * cin, cout), dtype=torch.float32,
                           device=x.device) if plan.splits > 1 else None)
    dw = torch.empty((9 * cin, cout), dtype=x.dtype, device=x.device)
    rc = _kernels()[1](x.data_ptr(), g.data_ptr(),
                       None if partial is None else partial.data_ptr(),
                       dw.data_ptr(), b, h, w, cin, cout, plan.rows,
                       plan.runs_per_block, plan.splits, _vec(x, cin),
                       _vec(g, cout), _stream(x))
    if rc != 0:
        raise RuntimeError(f"conv3x3_dw_bf16 launch failed with cudaError {rc} "
                           f"under {plan}")
    return dw


class _Conv3x3(torch.autograd.Function):
    """(x, wflat, bias) → y by K4; backward: dX by K4 on the rotated
    weights, dW by K5, db = ΣdY in fp32, each returned in the compute
    dtype, as the JAX custom VJP returns them. dX is skipped when x needs no
    gradient (a net's first layer fed by data): the JAX VJP computes it and
    throws it away."""

    @staticmethod
    def forward(ctx, x, wflat, bias):
        ctx.save_for_backward(x, wflat)
        return conv3x3_forward(x, wflat, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, wflat = ctx.saved_tensors
        g = g.contiguous()
        need_x, need_w, need_b = ctx.needs_input_grad
        g_x = conv3x3_dx(g, wflat) if need_x else None
        g_w = conv3x3_dw(x, g) if need_w else None
        g_b = (torch.sum(g, dim=(0, 1, 2), dtype=torch.float32).to(g.dtype)
               if need_b else None)
        return g_x, g_w, g_b


def conv3x3(x: torch.Tensor, kernel: torch.Tensor,
            bias: torch.Tensor | None = None,
            dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """3×3 SAME stride-1 conv, channels-last: x (B, H, W, Cin) × kernel (3,
    3, Cin, Cout) (+ bias (Cout,)) → (B, H, W, Cout) in `dtype`,
    differentiable in x, kernel and bias. Operands are cast to `dtype` (the
    bias too) and summed in fp32. CUDA tensors take bf16 only."""
    cin = x.shape[-1]
    if tuple(kernel.shape[:3]) != (3, 3, cin) or kernel.dim() != 4:
        raise ValueError(f"conv3x3 needs a (3, 3, {cin}, Co) kernel, got "
                         f"{tuple(kernel.shape)}")
    cout = kernel.shape[-1]
    wflat = kernel.to(dtype, memory_format=torch.contiguous_format).reshape(
        9 * cin, cout)
    return _Conv3x3.apply(x.to(dtype).contiguous(), wflat,
                          None if bias is None else bias.to(dtype))
