"""Sweep of K5's plan on one NVIDIA GPU: is `cuda_conv.dw_plan` near the best?

    python3 sweep_dw_plan.py

For each conv shape below (the 64², n=16, batch-8 training iteration's
shape families) it times K5 (`conv3x3_dw_bf16`, both passes) under every
plan of rows per run in {1, 2, 4, ..} and about 1, 2, 4, .., 1024 splits
that fits the card's shared memory, calling the C entry directly, and prints
the time under `dw_plan`'s plan, cuDNN's time for the same function and the
five fastest plans. Device times by CUDA-graph replay
(`chip_smoke._graph_ms`), beside the card's name and power limit. It checks
nothing: `chip_smoke.py` and `tests/test_torch_kernels.py` hold K5 to its
plain version.
"""

from __future__ import annotations

import numpy as np
import torch

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


def main() -> None:
    card = chip_smoke.device_phase()
    dev = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED)
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
