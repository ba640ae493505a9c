"""Evaluates rows of `generalize_smoke` (BASELINE config 4's
out-of-distribution evals) from one checkpoint with both packages, on the
CPU and on the same data, to tell nets that do not generalize from an
eval that differs between the packages.

    JAX_PLATFORMS=cpu python scripts/ood_crosscheck.py CKPT_DIR [--cases in_dist,inflow_shifted] [--num-val 32]

CKPT_DIR is a `ckpt_final` of config 4 written by either package (the CFE
48-96-96-48 and OP16 ... OP2). Each case's validation set is generated
once, by the JAX package's `generate_inflow_smoke_dataset` at the case's
seed and arguments (`pde_control_tpu/experiments/generalize.py ::
generalize_smoke`), and handed to both packages' `generalize._eval_app` /
`_row` (the staggered scheme, n = 16, batch 8, the nets restored from
CKPT_DIR). Prints each package's controlled final MSE ± sem, zero force,
ratio and mean |F|, and the two packages' relative gaps.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, SIZE = 16, 64
# case -> (seed, inflow_kwargs, the unseen obstacle course or the
# training one), as `generalize_smoke` evaluates it at the training horizon.
CASES = {"in_dist": (999, None, False),
         "obstacles_ood": (1999, None, True),
         "inflow_shifted": (2999, dict(y0=10.0, x_range=(0.05, 0.30)), False)}
PHYSICS = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-4, pressure_maxiter=200,
               warm_start_pressure=True)
PDE = dict(control="buoyancy", with_inflow=True, unet_levels=3,
           cfe_features=(48, 96, 96, 48), op_base_features=16)


def jax_rows(ckpt: str, cases: list, num_val: int) -> tuple[dict, dict]:
    """The JAX package's rows, and the validation sets it generated."""
    import jax.numpy as jnp

    from pde_control_tpu.control.pde_fluid import IncompressibleFluidPDE
    from pde_control_tpu.data.generate import generate_inflow_smoke_dataset
    from pde_control_tpu.experiments import generalize
    from pde_control_tpu.experiments.curriculum import op_spans
    from pde_control_tpu.experiments.fluid2d import default_obstacles
    from pde_control_tpu.grids import Domain2D
    from pde_control_tpu.physics.fluid import FluidConfig

    cfg = FluidConfig(**PHYSICS)
    restore = {net: ckpt for net in ("CFE",) + tuple(
        f"OP{s}" for s in op_spans(N))}
    rows, sets = {}, {}
    for case in cases:
        seed, inflow, ood = CASES[case]
        mask = (generalize.ood_obstacles if ood else default_obstacles)(
            SIZE, SIZE)
        domain = Domain2D.create(SIZE, SIZE, obstacle_mask=jnp.asarray(mask))
        val = generate_inflow_smoke_dataset(domain, cfg, num_val, N, seed=seed,
                                            control_amplitude=1.0,
                                            inflow_kwargs=inflow)
        pde = IncompressibleFluidPDE(domain, cfg, **PDE)
        rows[case] = generalize._row(generalize._eval_app(
            pde, N, val, restore, "staggered"), val, N)
        sets[case] = (np.array(mask), val)
    return rows, sets


def port_rows(ckpt: str, sets: dict) -> dict:
    """The port's rows on the JAX package's sets, on the CPU."""
    import torch

    from pde_control_tpu_torch.control.pde_fluid import IncompressibleFluidPDE
    from pde_control_tpu_torch.data.scene import TrajectoryDataset
    from pde_control_tpu_torch.experiments import generalize
    from pde_control_tpu_torch.experiments.curriculum import op_spans
    from pde_control_tpu_torch.grids import Domain2D
    from pde_control_tpu_torch.physics.fluid import FluidConfig

    torch.set_num_threads(min(8, torch.get_num_threads()))
    restore = {net: ckpt for net in ("CFE",) + tuple(
        f"OP{s}" for s in op_spans(N))}
    rows = {}
    for case, (mask, jval) in sets.items():
        val = TrajectoryDataset(jval.obs, **jval.extras)
        domain = Domain2D.create(SIZE, SIZE, obstacle_mask=mask, device="cpu")
        pde = IncompressibleFluidPDE(domain, FluidConfig(**PHYSICS), **PDE)
        rows[case] = generalize._row(generalize._eval_app(
            pde, N, val, restore, "staggered"), val, N)
    return rows


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ckpt")
    p.add_argument("--cases", default="in_dist,inflow_shifted")
    p.add_argument("--num-val", type=int, default=32)
    args = p.parse_args()
    cases = args.cases.split(",")
    unknown = sorted(set(cases) - set(CASES))
    if unknown:
        p.error(f"unknown cases {unknown}; known: {sorted(CASES)}")
    sys.path.insert(0, ROOT)
    ckpt = os.path.abspath(args.ckpt)
    jax, sets = jax_rows(ckpt, cases, args.num_val)
    port = port_rows(ckpt, sets)
    keys = ("final_state_mse", "zero_force_final_mse", "mean_abs_force")
    for case in cases:
        for name, r in (("JAX package", jax[case]), ("port", port[case])):
            print(f"{case:<15} {name:<12} controlled {r['final_state_mse']:.4e}"
                  f" ± {r['final_state_mse_sem']:.2e}, zero force "
                  f"{r['zero_force_final_mse']:.6e}, ratio "
                  f"{r['ratio_vs_zero_force']:.2f}x, mean |F| "
                  f"{r['mean_abs_force']:.3e}")
        print(f"{case:<15} port against the JAX package, relative: " + ", ".join(
            f"{k} {abs(port[case][k] - jax[case][k]) / abs(jax[case][k]):.3e}"
            for k in keys), flush=True)


if __name__ == "__main__":
    main()
