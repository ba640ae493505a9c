"""CLI for the benchmark experiments.

    python -m pde_control_tpu_torch.experiments.run <name> [--smoke-test] \
        [--workdir DIR] [--iterations N] [--datadir DIR] [--resume] \
        [--device cuda|cpu] …

Counterpart of `pde_control_tpu/experiments/run.py`, with the same names,
flags and per-experiment flag table, plus `--device` (default `cuda`;
`cpu` runs the kernels' plain versions). Ported: the five BASELINE
configs with their fine-tunes: `burgers_chain` (config 1),
`burgers_hierarchical` (config 2), `shape_transition` (config 3),
`shape_transition_ft`, `shape_transition_rings_ft`, `smoke_indirect`
(config 4), `smoke_indirect_ft`, `natural_flow_128` (config 5) and
`natural_flow_128_ft`; the indirect smoke task at 128² (`smoke_128`,
`smoke_128_ft`; the pressure solve on K1 at 128²); the 3D smoke tasks
(`smoke3d`, `smoke3d_ft`: 24³ without obstacles, n=8;
`smoke3d_indirect`, `smoke3d_indirect_ft`: 32³ with the plate, n=16);
the adjoint baseline `burgers_adjoint`; the scheme comparisons
`compare_burgers`, `compare_smoke`, `compare_smoke_long` and
`compare_smoke_64` (`comparison.json`); and the out-of-distribution evals
`generalize_shapes` and `generalize_smoke`, which restore a finished
run's ckpt_final (`--init-from`, either package's) and train nothing.
`--mesh N` trains data-parallel over N ranks (`parallel/mesh.py`): launch
it under torchrun, `torchrun --nproc-per-node N -m
pde_control_tpu_torch.experiments.run <name> --mesh N …` (NCCL, one card
per rank; with `--device cpu`, gloo); it is taken by the entries that
train through the curriculum (`MESH_ENTRIES`), and only rank 0 writes
files and prints the result. `burgers_chain` and `burgers_adjoint` also
write their printed result to `results.json` in the workdir. `--smoke-test` shrinks every dimension for a fast CI-sized
run.
"""

from __future__ import annotations

import argparse
import json
import os

from pde_control_tpu_torch.experiments import (
    burgers,
    compare_schemes,
    fluid2d,
    generalize,
    smoke3d,
)
from pde_control_tpu_torch.experiments.curriculum import _write_results

NAMES = [
    "burgers_chain", "burgers_hierarchical", "shape_transition",
    "smoke_indirect", "natural_flow_128", "burgers_adjoint",
    "compare_burgers", "compare_smoke", "compare_smoke_long",
    "compare_smoke_64", "smoke3d", "smoke3d_indirect",
    "smoke3d_indirect_ft", "smoke3d_ft", "smoke_128", "smoke_128_ft",
    "natural_flow_128_ft", "smoke_indirect_ft",
    "shape_transition_ft", "shape_transition_rings_ft",
    "generalize_shapes", "generalize_smoke"]
PORTED = ("burgers_chain", "burgers_hierarchical", "burgers_adjoint",
          "compare_burgers", "compare_smoke", "compare_smoke_long",
          "compare_smoke_64", "shape_transition", "shape_transition_ft",
          "shape_transition_rings_ft", "smoke_indirect", "smoke_indirect_ft",
          "natural_flow_128", "natural_flow_128_ft", "generalize_shapes",
          "generalize_smoke", "smoke_128", "smoke_128_ft", "smoke3d",
          "smoke3d_ft", "smoke3d_indirect", "smoke3d_indirect_ft")
# The entries that take `mesh` in the JAX package's CLI too.
MESH_ENTRIES = ("shape_transition", "shape_transition_ft",
                "shape_transition_rings_ft", "smoke_indirect",
                "smoke_indirect_ft", "smoke_128", "smoke_128_ft", "smoke3d",
                "smoke3d_ft", "smoke3d_indirect", "smoke3d_indirect_ft",
                "natural_flow_128", "natural_flow_128_ft")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("name", choices=NAMES)
    p.add_argument("--workdir", default=None)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--smoke-test", action="store_true")
    p.add_argument("--mesh", type=int, default=None,
                   help="data-parallel over N ranks (launch under torchrun "
                        "with --nproc-per-node N)")
    p.add_argument("--num-train", type=int, default=None,
                   help="override training-trajectory count")
    p.add_argument("--num-val", type=int, default=None,
                   help="override validation-trajectory count")
    p.add_argument("--e2e-iterations", type=int, default=None,
                   help="override the e2e stage's iteration count "
                        "(supervised stages keep --iterations)")
    p.add_argument("--datadir", default=None,
                   help="scene-tree dataset cache root: generate once to "
                        "disk, reload thereafter (the JAX package's "
                        "layout and keys)")
    p.add_argument("--seed", type=int, default=None,
                   help="training seed (multi-seed spread studies)")
    p.add_argument("--init-from", default=None,
                   help="finished run's ckpt_final to restore ALL networks "
                        "from (fine-tune entries; either package's)")
    p.add_argument("--force-reg", type=float, default=None,
                   help="force-regularizer override (fine-tune entries)")
    p.add_argument("--width", type=int, default=None,
                   help="net-width multiplier")
    p.add_argument("--batch", type=int, default=None,
                   help="batch-size override (the judged protocol default "
                        "is 8)")
    p.add_argument("--lr-scale", type=float, default=None,
                   help="multiply every stage LR (batch-scaling protocol: "
                        "sqrt(batch/8) for a matched-sample-budget run)")
    p.add_argument("--sequence", default=None,
                   choices=("staggered", "refined"),
                   help="e2e sequence scheme")
    p.add_argument("--resume", action="store_true",
                   help="skip curriculum stages whose checkpoint already "
                        "exists in --workdir and restore an interrupted "
                        "stage's autosave")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run: cuda (default) or cpu")
    return p


def _supports() -> dict:
    """Which experiments consume each flag that only some take (the JAX
    package's table)."""
    ft = {"smoke3d_indirect_ft", "smoke3d_ft", "smoke_128_ft",
          "natural_flow_128_ft", "smoke_indirect_ft", "shape_transition_ft",
          "shape_transition_rings_ft"}
    return {
        "batch": {"smoke_indirect", "shape_transition", "natural_flow_128",
                  "smoke_128"},
        "lr_scale": {"smoke_indirect"},
        "sequence": {"natural_flow_128"},
        "num_train": {"smoke_indirect", "smoke3d", "smoke3d_indirect",
                      "natural_flow_128", "shape_transition",
                      "smoke_128"} | ft,
        "e2e_iterations": {"smoke_indirect", "smoke3d", "smoke3d_indirect",
                           "natural_flow_128", "smoke_128"} | ft,
        "datadir": {"smoke_indirect", "natural_flow_128",
                    "shape_transition", "smoke_128"} | ft - {
                        "smoke3d_indirect_ft", "smoke3d_ft",
                        "shape_transition_rings_ft"},
        "seed": {"smoke_indirect", "natural_flow_128", "shape_transition",
                 "smoke3d", "smoke3d_indirect", "smoke_128"} | ft,
        "resume": {"smoke_indirect", "natural_flow_128", "shape_transition",
                   "smoke_128", "smoke3d", "smoke3d_indirect",
                   "compare_burgers", "compare_smoke", "compare_smoke_long",
                   "compare_smoke_64"} | ft,
        "init_from": ft | {"generalize_shapes", "generalize_smoke"},
        "force_reg": ft - {"shape_transition_rings_ft"},
        "width": {"smoke_indirect", "smoke_128", "generalize_smoke"},
        "num_val": {"smoke_indirect", "natural_flow_128", "shape_transition",
                    "smoke_128", "smoke3d", "smoke3d_indirect",
                    "generalize_shapes", "generalize_smoke"} | ft,
    }


def _burgers_adjoint(workdir: str, st: bool, it: int | None, device) -> dict:
    """The paper's classical comparator on Burgers: direct force
    optimization through the differentiable solver (no networks) on 8
    validation trajectories."""
    import numpy as np
    import torch

    from pde_control_tpu_torch.control.adjoint import optimize_forces
    from pde_control_tpu_torch.control.pde_burgers import BurgersPDE

    n = 4 if st else 32
    _, val = burgers.make_datasets(n, 8 if st else 32, 8, workdir,
                                   device=device)
    pde = BurgersPDE(burgers.BURGERS_CFG, device=device)
    batch = {k: torch.as_tensor(v, device=pde.device) for k, v in
             val.sample(np.random.default_rng(0), 8).items()}
    _, hist = optimize_forces(
        pde, pde.initial_state(batch), batch["obs"][:, n], n=n,
        iterations=it or (50 if st else 500), learning_rate=0.1,
        force_reg=1e-4)
    return {
        "final_obs_mse": float(hist["obs_loss"][-1]),
        "initial_obs_mse": float(hist["obs_loss"][0]),
        "mean_force_cost": float(hist["force_cost"][-1]),
    }


def main(argv=None) -> None:
    p = _parser()
    args = p.parse_args(argv)
    for flag, names in _supports().items():
        # `v is not False`, not `v not in (None, False)`: 0 == False, and
        # a 0-valued int flag (--seed 0) must still error on experiments
        # that do not take it.
        v = getattr(args, flag)
        if v is not None and v is not False and args.name not in names:
            p.error(f"--{flag.replace('_', '-')} is not supported by "
                    f"{args.name!r} (supported: {sorted(names)})")
    if args.name not in PORTED:
        p.error(f"{args.name} is not ported yet")
    mesh = None
    if args.mesh:
        if args.name not in MESH_ENTRIES:
            p.error(f"--mesh is not supported by {args.name!r} (supported: "
                    f"{sorted(MESH_ENTRIES)})")
        if os.environ.get("WORLD_SIZE") != str(args.mesh):
            p.error(f"--mesh {args.mesh} needs a torchrun launch with "
                    f"WORLD_SIZE == {args.mesh}: torchrun --nproc-per-node "
                    f"{args.mesh} -m pde_control_tpu_torch.experiments.run "
                    f"{args.name} --mesh {args.mesh} …")
        from pde_control_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(args.mesh,
                         device="cpu" if args.device == "cpu" else None)

    workdir = args.workdir or f"runs/{args.name}"
    st = args.smoke_test
    it = args.iterations
    dev = dict(device=args.device if mesh is None else mesh.device)
    if args.name.endswith("_ft") and not args.init_from:
        base = args.name[:-3].replace("_rings", "")
        p.error(f"{args.name} requires --init-from "
                f"(a finished {base} run's ckpt_final)")
    common = dict(datadir=args.datadir, seed=args.seed or 0,
                  resume=args.resume, **dev,
                  **({"mesh": mesh} if mesh is not None else {}))
    sizes = dict(size=16 if st else 64, n=4 if st else 16,
                 num_train=args.num_train or (16 if st else 256),
                 num_val=args.num_val or (8 if st else 32))
    ft = dict(init_from=args.init_from,
              e2e_iterations=args.e2e_iterations or (5 if st else None),
              batch_size=4 if st else 8)
    if args.name in ("generalize_shapes", "generalize_smoke"):
        if not args.init_from:
            p.error(f"{args.name} requires --init-from "
                    "(a finished run's ckpt_final)")
        fn = getattr(generalize, args.name)
        kw = {"width": args.width} if args.width else {}
        result = fn(workdir, init_from=args.init_from,
                    num_val=args.num_val or (8 if st else 32),
                    smoke_test=st, **kw, **dev)
    elif args.name == "burgers_adjoint":
        result = _burgers_adjoint(workdir, st, it, args.device)
    elif args.name.startswith("compare_"):
        fn = getattr(compare_schemes, args.name)
        result = fn(workdir, smoke_test=st, resume=args.resume,
                    **({"iterations": it} if it else {}), **dev)
    elif args.name == "burgers_chain":
        result = burgers.run_chain_supervised(
            workdir, n=4 if st else 32,
            iterations=it or (30 if st else 2000),
            num_train=64 if st else 1024, num_val=16 if st else 128,
            batch_size=8 if st else 32, **dev)
    elif args.name == "burgers_hierarchical":
        result = burgers.run_hierarchical(
            workdir, n=4 if st else 32,
            iterations=it or (30 if st else 1000),
            num_train=64 if st else 1024, num_val=16 if st else 128,
            batch_size=8 if st else 32, **dev)
    elif args.name == "shape_transition":
        result = fluid2d.run_shape_transition(
            workdir, iterations=it or (10 if st else 500),
            batch_size=args.batch or (4 if st else 8), **sizes, **common)
    elif args.name == "shape_transition_ft":
        result = fluid2d.run_shape_transition_ft(
            workdir, force_reg=args.force_reg or 5e-6, **ft, **sizes, **common)
    elif args.name == "shape_transition_rings_ft":
        del common["datadir"]
        result = fluid2d.run_shape_transition_rings_ft(
            workdir, **ft, **sizes, **common)
    elif args.name == "smoke_indirect":
        result = fluid2d.run_smoke_indirect(
            workdir, iterations=it or (10 if st else 500),
            e2e_iterations=args.e2e_iterations,
            batch_size=args.batch or (4 if st else 8),
            width=args.width or 1, lr_scale=args.lr_scale or 1.0, **sizes,
            **common)
    elif args.name == "smoke_indirect_ft":
        result = fluid2d.run_smoke_indirect_ft(
            workdir, force_reg=args.force_reg or 1.5e-5, **ft, **sizes,
            **common)
    elif args.name in ("smoke_128", "smoke_128_ft"):  # 32², n=4 smoke test
        sizes.update(size=32 if st else 128)
        if args.name == "smoke_128":
            result = fluid2d.run_smoke_indirect(
                workdir, iterations=it or (10 if st else 1000),
                e2e_iterations=args.e2e_iterations,
                batch_size=args.batch or (4 if st else 8),
                width=args.width or 1, **sizes, **common)
        else:
            result = fluid2d.run_smoke_indirect_ft(
                workdir, force_reg=args.force_reg or 1.5e-5, **ft, **sizes,
                **common)
    elif args.name.startswith("smoke3d"):  # 8³, n=2 smoke test
        del common["datadir"]
        plate = args.name.startswith("smoke3d_indirect")
        sizes = dict(size=8 if st else (32 if plate else 24),
                     n=2 if st else (16 if plate else 8),
                     num_train=args.num_train or (
                         8 if st else (128 if plate else 64)),
                     num_val=args.num_val or (4 if st else 16))
        if args.name == "smoke3d":
            result = smoke3d.run_smoke3d(
                workdir, iterations=it or (5 if st else 300),
                e2e_iterations=args.e2e_iterations,
                batch_size=4 if st else 8, **sizes, **common)
        elif args.name == "smoke3d_ft":
            result = smoke3d.run_smoke3d_ft(
                workdir, force_reg=args.force_reg or 5e-6, **ft, **sizes,
                **common)
        elif args.name == "smoke3d_indirect":
            result = smoke3d.run_smoke3d_indirect(
                workdir, iterations=it or (5 if st else 400),
                e2e_iterations=args.e2e_iterations,
                batch_size=4 if st else 8, **sizes, **common)
        else:
            result = smoke3d.run_smoke3d_indirect_ft(
                workdir, force_reg=args.force_reg or 1.5e-5, **ft, **sizes,
                **common)
    else:  # config 5: 16², n=8 for the smoke test
        sizes.update(n=8 if st else 128,
                     num_train=args.num_train or (16 if st else 128),
                     num_val=args.num_val or (8 if st else 16))
        if args.name == "natural_flow_128":
            result = fluid2d.run_natural_flow_128(
                workdir, iterations=it or (10 if st else 300),
                e2e_iterations=args.e2e_iterations,
                batch_size=args.batch or (4 if st else 8),
                sequence=args.sequence or "staggered", **sizes, **common)
        else:
            result = fluid2d.run_natural_flow_128_ft(
                workdir, force_reg=args.force_reg or 5e-6, **ft, **sizes,
                **common)
    if args.name in ("burgers_chain", "burgers_adjoint"):
        _write_results(workdir, result)  # the other entries write their own
    if mesh is None or mesh.rank == 0:
        print(json.dumps(result, indent=2, default=float))
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
