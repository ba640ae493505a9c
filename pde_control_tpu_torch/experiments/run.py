"""CLI for the benchmark experiments.

    python -m pde_control_tpu_torch.experiments.run <name> [--smoke-test] \
        [--workdir DIR] [--iterations N] [--datadir DIR] [--resume] \
        [--device cuda|cpu] …

Counterpart of `pde_control_tpu/experiments/run.py`, with the same names,
flags and per-experiment flag table, plus `--device` (default `cuda`;
`cpu` runs the kernels' plain versions). Ported: `smoke_indirect`
(BASELINE config 4) and its fine-tune `smoke_indirect_ft`; every other
name exits with "not ported yet". `--smoke-test` shrinks every dimension
for a fast CI-sized run.
"""

from __future__ import annotations

import argparse
import json

from pde_control_tpu_torch.experiments import fluid2d

NAMES = [
    "burgers_chain", "burgers_hierarchical", "shape_transition",
    "smoke_indirect", "natural_flow_128", "burgers_adjoint",
    "compare_burgers", "compare_smoke", "compare_smoke_long",
    "compare_smoke_64", "smoke3d", "smoke3d_indirect",
    "smoke3d_indirect_ft", "smoke3d_ft", "smoke_128", "smoke_128_ft",
    "natural_flow_128_ft", "smoke_indirect_ft",
    "shape_transition_ft", "shape_transition_rings_ft",
    "generalize_shapes", "generalize_smoke"]
PORTED = ("smoke_indirect", "smoke_indirect_ft")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("name", choices=NAMES)
    p.add_argument("--workdir", default=None)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--smoke-test", action="store_true")
    p.add_argument("--mesh", type=int, default=None,
                   help="data-parallel over N devices (not ported yet)")
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
    if args.mesh:
        p.error("--mesh (data parallelism) is not ported yet")

    workdir = args.workdir or f"runs/{args.name}"
    st = args.smoke_test
    it = args.iterations
    dev = dict(device=args.device)
    if args.name == "smoke_indirect":
        result = fluid2d.run_smoke_indirect(
            workdir, size=16 if st else 64, n=4 if st else 16,
            iterations=it or (10 if st else 500),
            e2e_iterations=args.e2e_iterations,
            num_train=args.num_train or (16 if st else 256),
            num_val=args.num_val or (8 if st else 32),
            batch_size=args.batch or (4 if st else 8),
            datadir=args.datadir, seed=args.seed or 0, resume=args.resume,
            width=args.width or 1, lr_scale=args.lr_scale or 1.0, **dev)
    else:  # smoke_indirect_ft
        if not args.init_from:
            p.error("smoke_indirect_ft requires --init-from "
                    "(a finished smoke_indirect run's ckpt_final)")
        result = fluid2d.run_smoke_indirect_ft(
            workdir, init_from=args.init_from,
            force_reg=args.force_reg or 1.5e-5,
            size=16 if st else 64, n=4 if st else 16,
            e2e_iterations=args.e2e_iterations or (5 if st else None),
            num_train=args.num_train or (16 if st else 256),
            num_val=args.num_val or (8 if st else 32),
            batch_size=4 if st else 8,
            datadir=args.datadir, seed=args.seed or 0, resume=args.resume,
            **dev)
    print(json.dumps(result, indent=2, default=float))


if __name__ == "__main__":
    main()
