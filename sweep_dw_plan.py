"""Sweep of the conv kernels' plans on one NVIDIA GPU: are
`cuda_conv.dw_plan` (K5) and `cuda_conv.fwd_plan` (K4) near the best?

    python3 sweep_dw_plan.py          # K5, then K4
    python3 sweep_dw_plan.py fwd      # K4 only

For each conv shape below (the 64², n=16, batch-8 training iteration's
shape families) it times K5 (`conv3x3_dw_bf16`, both passes) under every
plan of rows per run in {1, 2, 4, ..} and about 1, 2, 4, .., 1024 splits
that fits the card's shared memory, and K4 (`conv3x3_fwd_bf16`, forward
and dX, both passes) under every output-channel tile and fragments per
warp it has and every count of splits of K, calling the C entries
directly. It prints the time under the plan's choice, cuDNN's time for the
same function and the five fastest plans. Device times by CUDA-graph
replay (`chip_smoke._graph_ms`), beside the card's name and power limit.
It checks nothing: `chip_smoke.py` and `tests/test_torch_kernels.py` hold
the kernels to their plain versions.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke
from pde_control_tpu_torch.ops import cuda_conv

# (batch, H, W, Cin, Cout)
SHAPES = [(8, 64, 64, 64, 64), (8, 64, 64, 32, 64), (8, 64, 64, 64, 32),
          (8, 64, 64, 5, 32), (8, 64, 64, 32, 1), (64, 64, 64, 3, 16),
          (64, 64, 64, 16, 16), (64, 64, 64, 32, 16), (64, 32, 32, 32, 32),
          (64, 32, 32, 64, 32), (64, 16, 16, 64, 64), (16, 16, 16, 128, 64),
          (8, 8, 8, 128, 128), (64, 8, 8, 128, 128)]


def _launcher(shape, x, g, rows: int, runs_per_block: int):
    """A call of K5 under the given plan, and the plan's splits."""
    b, h, w, cin, cout = shape
    splits = -(-b * -(-h // rows) // runs_per_block)
    partial = torch.empty((splits, 9 * cin, cout), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((9 * cin, cout), dtype=x.dtype, device=x.device)
    kernel = cuda_conv._kernels()[1]

    def call():
        rc = kernel(x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                    b, h, w, cin, cout, rows, runs_per_block, splits,
                    cuda_conv._vec(x, cin), cuda_conv._vec(g, cout),
                    cuda_conv._stream(x))
        if rc != 0:
            raise RuntimeError(f"conv3x3_dw_bf16 failed with cudaError {rc}")

    return call, splits


def _fwd_launcher(x, wgt, bias, cin: int, cout: int, rotated: bool, bn: int,
                  fm: int, seg: int, splits: int):
    """A call of K4 on x (b, h, w, cin) → (b, h, w, cout) under the given
    plan."""
    b, h, w, _ = x.shape
    partial = torch.empty((splits, b * h * w, cout), dtype=torch.float32,
                          device=x.device)
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    kernel = cuda_conv._kernels()[0]
    vec_w = cuda_conv._vec(wgt, cin if rotated else cout)

    def call():
        rc = kernel(x.data_ptr(), wgt.data_ptr(),
                    None if bias is None else bias.data_ptr(), y.data_ptr(),
                    partial.data_ptr(), b, h, w, cin, cout, int(rotated), bn,
                    fm, seg, splits, cuda_conv._vec(x, cin), vec_w,
                    cuda_conv._stream(x))
        if rc != 0:
            raise RuntimeError(f"conv3x3_fwd_bf16 failed with cudaError {rc}")

    return call


def sweep_fwd(card: str, rng) -> None:
    dev = torch.device("cuda")
    for shape in SHAPES:
        b, h, w, cin, cout = shape
        x, g = (torch.tensor(rng.normal(size=(b, h, w, c)), dtype=torch.float32,
                             device=dev).to(torch.bfloat16) for c in (cin, cout))
        wflat = torch.tensor(rng.normal(size=(9 * cin, cout)) / np.sqrt(9 * cin),
                             dtype=torch.float32, device=dev).to(torch.bfloat16)
        bias = torch.zeros(cout, dtype=torch.bfloat16, device=dev)
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        w_oihw = wflat.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous()
        for d, inp, k_in, k_out, rotated, plan_call, library in (
                ("fwd", x, cin, cout, False,
                 lambda: cuda_conv.conv3x3_forward(x, wflat, bias),
                 lambda: F.conv2d(xn, w_oihw, bias, padding=1)),
                ("dX", g, cout, cin, True, lambda: cuda_conv.conv3x3_dx(g, wflat),
                 lambda: torch.nn.grad.conv2d_input(xn.shape, w_oihw, gn,
                                                    padding=1))):
            plan = cuda_conv.fwd_plan(b, h, w, k_in, k_out)
            plan_ms = chip_smoke._graph_ms(plan_call, 20)
            library_ms = chip_smoke._graph_ms(library, 20)
            slices = -(-k_in // 16)
            swept = {}
            for bn, fm in cuda_conv.FWD_TILES:
                seg = w
                while (seg > 1 and cuda_conv.fwd_shared_bytes(bn, fm, seg, w)
                       > cuda_conv.MAX_SHARED_BYTES):
                    seg = -(-seg // 2)
                for splits in sorted({-(-slices // p) for p in range(1, slices + 1)}):
                    call = _fwd_launcher(inp, wflat, None if rotated else bias,
                                         k_in, k_out, rotated, bn, fm, seg, splits)
                    swept[bn, fm, splits] = chip_smoke._graph_ms(call, 20)
            ranked = sorted((ms, key) for key, ms in swept.items())
            print(f"K4 {d} {b}x{h}x{w} {k_in}->{k_out}: fwd_plan bn {plan.bn} x "
                  f"fm {plan.fm} x seg {plan.seg} x splits {plan.splits} "
                  f"{plan_ms:.4f} ms, cuDNN {library_ms:.4f} ms; fastest swept: "
                  + "; ".join(f"{ms:.4f} ms bn {bn} x fm {fm} x splits {s}"
                              for ms, (bn, fm, s) in ranked[:5])
                  + f" [{card}]", flush=True)
            print("  all swept (ms bn fm splits): " + ", ".join(
                f"{ms:.4f} {bn} {fm} {s}" for ms, (bn, fm, s) in ranked))


def main() -> None:
    card = chip_smoke.device_phase()
    rng = np.random.default_rng(chip_smoke.SEED)
    if sys.argv[1:] != ["fwd"]:
        sweep_dw(card, rng)
    sweep_fwd(card, rng)


def sweep_dw(card: str, rng) -> None:
    dev = torch.device("cuda")
    for shape in SHAPES:
        b, h, w, cin, cout = shape
        x, g = (torch.tensor(rng.normal(size=(b, h, w, c)), dtype=torch.float32,
                             device=dev).to(torch.bfloat16) for c in (cin, cout))
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        library_ms = chip_smoke._graph_ms(
            lambda: torch.nn.grad.conv2d_weight(xn, (cout, cin, 3, 3), gn,
                                                padding=1), 20)
        plan = cuda_conv.dw_plan(*shape)
        plan_ms = chip_smoke._graph_ms(lambda: cuda_conv.conv3x3_dw(x, g), 20)
        swept = {}
        for rows in (r for r in (1, 2, 4, 8, 16, 32, 64) if r <= h):
            shared = cuda_conv.dw_shared_bytes(rows, w, cin, cout)
            if shared > cuda_conv.MAX_SHARED_BYTES:
                continue
            total_runs = b * -(-h // rows)
            for target in (2 ** i for i in range(11) if 2 ** i <= total_runs):
                runs_per_block = -(-total_runs // target)
                call, splits = _launcher(shape, x, g, rows, runs_per_block)
                if (rows, splits) not in swept:
                    swept[rows, splits] = (chip_smoke._graph_ms(call, 20),
                                           runs_per_block, shared)
        best = sorted((ms, rows, rpb, splits, shared)
                      for (rows, splits), (ms, rpb, shared) in swept.items())[:5]
        print(f"{b}x{h}x{w} {cin}->{cout}: dw_plan rows {plan.rows} x runs "
              f"{plan.runs_per_block} x splits {plan.splits} {plan_ms:.4f} ms, "
              f"cuDNN {library_ms:.4f} ms; fastest swept: " + "; ".join(
                  f"{ms:.4f} ms rows {rows} x runs {rpb} x splits {splits} "
                  f"({shared} B shared)" for ms, rows, rpb, splits, shared in best)
              + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()
