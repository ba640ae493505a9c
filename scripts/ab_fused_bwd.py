"""Times the fluid-step kernels of one or more trees of the PyTorch port on
one NVIDIA GPU, in turns, for an A/B of K3 (the fused step's backward).

    python3 scripts/ab_fused_bwd.py TREE [TREE ...]

Each TREE is the root of a checkout (its `pde_control_tpu_torch/` is
imported, and built into its own `_build/`); each runs in a process of
its own, in the order given. The operands, the step and the timers are
this repo's `chip_smoke.py`'s (`_fused_operands`, `FUSED_STEP`, `_time_ms`,
`_graph_ms`), so every tree gets the same inputs from the same seed: the
64² closed box with the plate obstacle, warm operands with a force. For
each tree:
  * K3 at batch 8, tol 1e-4 / maxiter 100 (the main path's settings);
  * K3 at batch 8, maxiter 0: one preconditioner application and no CG
    trip, so the difference to the line above is the transpose solve;
  * K3 at batch 64, tol 1e-4 / maxiter 100;
  * K2 at batch 8, tol 1e-4 / maxiter 100, warm start;
  * K1 cold at batch 8, tol 1e-4 / maxiter 100.
Time per launch by CUDA events over a host loop of 50 launches (`ms`,
chip_smoke's yardstick for K1-K3) and by CUDA-graph replay of 20 launches
(`graph_ms`, the host left out); the trip counts; the card's name and
power limit. It checks nothing: `chip_smoke.py` and
`tests/test_torch_kernels.py` hold the kernels to their plain versions.
One JSON line per tree.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0


def _one(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import numpy as np
    import torch

    from pde_control_tpu_torch.grids import Domain2D
    from pde_control_tpu_torch.ops import cuda_cg, cuda_fluid

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    h = smoke.H
    domain = Domain2D.create(h, h, obstacle_mask=smoke._plate(h), device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    flags = dict(has_force=True, has_inflow=False)
    out = {"tree": tree}
    for batch in (smoke.BATCH, 64):
        rng = np.random.default_rng(SEED + batch)
        ops, cots = smoke._fused_operands(rng, h, h, "warm", domain, dev,
                                          batch=batch)
        state = (ops.pop("vy"), ops.pop("vx"), ops.pop("rho"))
        runs = [("K3", 100)] + ([("K3 maxiter 0", 0), ("K2", 100),
                                 ("K1 cold", 100)] if batch == 8 else [])
        for name, maxiter in runs:
            kw = dict(smoke.FUSED_STEP, dx=domain.dx, tol=1e-4, maxiter=maxiter)
            if name.startswith("K3"):
                def fn(kw=kw):
                    return cuda_fluid.fused_step_backward(*state, *cots, *geom,
                                                          **flags, **kw)
            elif name == "K2":
                def fn(kw=kw):
                    return cuda_fluid.fused_step_forward(*state, *geom, **ops,
                                                         **kw)
            else:
                def fn():
                    return cuda_cg.pressure_solve(cots[3], *geom, dx=domain.dx,
                                                  closed=True, tol=1e-4,
                                                  maxiter=100)
            trips = fn()[-1]
            out[f"{name} b{batch}"] = dict(
                ms=smoke._time_ms(fn, 50), graph_ms=smoke._graph_ms(fn, 20),
                trips=trips.tolist() if batch == 8 else
                float(trips.float().mean()))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    return out


def main() -> None:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(_one(sys.argv[2])), flush=True)
        return
    if not sys.argv[1:]:
        raise SystemExit(__doc__)
    for tree in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                               tree], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        print(proc.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
