"""Times the fluid-step kernels of one or more trees of the PyTorch port on
one NVIDIA GPU, in turns, for an A/B of K1 (the pressure solve), K2 and
K3 (the fused step's forward and backward).

    python3 scripts/ab_fused_bwd.py TREE [TREE ...]

Each TREE is the root of a checkout (its `pde_control_tpu_torch/` is
imported, and built into its own `_build/`); each runs in a process of
its own, in the order given. The operands, the step and the timers are
this repo's `chip_smoke.py`'s (`_fused_operands`, `FUSED_STEP`, `_time_ms`,
`_graph_ms`), so every tree gets the same inputs from the same seed: the
closed box with the plate obstacle, warm operands with a force, at 64²
(batch 8 and 64; the small layouts) and at 128² (batch 8; the large
layouts). For each tree, grid and batch, tol 1e-4 / maxiter 100 (the main
path's settings) and at maxiter 0 (one preconditioner application and no
CG trip, so that the difference is the solve's trips):
  * K3, the cold transpose solve on the operands' cotangents;
  * K2, warm-started from the operands' guess;
  * K1 cold on the pressure cotangent as `div`, and K1 warm from the plain
    solution of that `div` (tol 1e-6) with 5% noise, as `chip_smoke.py`
    makes its guess.
Time per launch by CUDA events over a host loop of 50 launches (`ms`,
chip_smoke's yardstick for K1-K3) and by CUDA-graph replay of 20 launches
(`graph_ms`, the host left out); the mean trip count; at tol 1e-4 the
outputs' SHA-256 (`digest`, the first 16 hex digits; equal digests of two
trees are the same output bits) and each kernel's plan at each batch; the
split into µs a trip, (graph_ms − graph_ms at maxiter 0) / mean trips,
and the rest (the time at maxiter 0; graph replay, since at maxiter 0 a
host loop of events reads the wrapper's enqueue); the card's name and
power limit. It checks nothing: `chip_smoke.py` and
`tests/test_torch_kernels.py` hold the kernels to their plain versions.
One JSON line per tree.
"""

from __future__ import annotations

import hashlib
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
    flags = dict(has_force=True, has_inflow=False)
    out = {"tree": tree}
    for h, batch in ((smoke.H, smoke.BATCH), (smoke.H, 64), (128, smoke.BATCH)):
        domain = Domain2D.create(h, h, obstacle_mask=smoke._plate(h), device=dev)
        geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
        rng = np.random.default_rng(SEED + batch + (0 if h == smoke.H else h))
        at = f"b{batch}" if h == smoke.H else f"{h}x{h} b{batch}"
        ops, cots = smoke._fused_operands(rng, h, h, "warm", domain, dev,
                                          batch=batch)
        state = (ops.pop("vy"), ops.pop("vx"), ops.pop("rho"))
        div = cots[3]
        p = cuda_cg.pcg_plain(div, *geom, dx=domain.dx, closed=True, tol=1e-6,
                              maxiter=500)[0]
        noise = torch.tensor(rng.normal(size=tuple(div.shape)),
                             dtype=torch.float32, device=dev)
        guess = {"K1 cold": None,
                 "K1 warm": (p + 0.05 * p.std() * noise).contiguous()}
        for name in ("K3", "K2", "K1 cold", "K1 warm"):
            for maxiter in (100, 0):
                kw = dict(smoke.FUSED_STEP, dx=domain.dx, tol=1e-4,
                          maxiter=maxiter)
                if name == "K3":
                    def fn(kw=kw):
                        return cuda_fluid.fused_step_backward(
                            *state, *cots, *geom, **flags, **kw)
                elif name == "K2":
                    def fn(kw=kw):
                        return cuda_fluid.fused_step_forward(*state, *geom,
                                                             **ops, **kw)
                else:
                    def fn(x0=guess[name], maxiter=maxiter):
                        return cuda_cg.pressure_solve(
                            div, *geom, x0=x0, dx=domain.dx, closed=True,
                            tol=1e-4, maxiter=maxiter)
                got = fn()
                trips = got[-1]
                label = f"{name} {at}" + (" maxiter 0" if not maxiter else "")
                out[label] = dict(
                    ms=smoke._time_ms(fn, 50), graph_ms=smoke._graph_ms(fn, 20),
                    trips=float(trips.float().mean()))
                if maxiter:
                    digest = hashlib.sha256()
                    for t in got:
                        if t is not None:
                            digest.update(t.cpu().numpy().tobytes())
                    out[label]["digest"] = digest.hexdigest()[:16]
            full, rest = out[f"{name} {at}"], out[f"{name} {at} maxiter 0"]
            full["us_per_trip"] = (1e3 * (full["graph_ms"] - rest["graph_ms"])
                                   / full["trips"])
        out[f"plans {at}"] = {
            "K1": smoke._plan_text(cuda_cg.solve_plan(batch, h, h)),
            "K2": smoke._plan_text(cuda_fluid.fwd_plan(batch, h, h)),
            "K3": smoke._plan_text(cuda_fluid.bwd_plan(
                batch, h, h, smoke.FUSED_STEP["max_shift"]))}
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
