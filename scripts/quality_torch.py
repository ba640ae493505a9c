"""Trains BASELINE config 4 (indirect smoke control) or config 3 (shape
transition) with the port at the JAX package's published counts, and
prints the result beside the JAX package's.

    python3 scripts/quality_torch.py config4|config3 [--draws jax|port]

The counts are those of the JAX package's published runs
(`scripts/run_quality11.sh`): config 4 `--iterations 4000
--e2e-iterations 8000 --num-train 512`, config 3 `--iterations 3500
--num-train 512`, seed 0, 32 validation trajectories, on the entries'
default routes.

* `--draws jax` (the default) trains on the JAX package's own datasets:
  the port's draw functions (`data/generate.py :: inflow_draws,
  smooth_field_draws`, and `INITS['shapes']`'s draws) are replaced in this
  process by pops from `tests/goldens/jax_draws_config{4,3}.npz`
  (`scripts/make_jax_draws.py`), chunk by chunk, the training set's from
  the generator seeded 0 and the validation set's from the one seeded
  999; then `fluid2d.run_smoke_indirect` / `run_shape_transition` run in
  `runs/quality_torch/config{4,3}_jax`. The zero-force MSE must then equal
  the JAX package's within 1e-2 relative: that holds the data path.
* `--draws port` runs the port's CLI, unpatched, in a subprocess, as a
  user would (`python -m pde_control_tpu_torch.experiments.run
  smoke_indirect …` into `runs/quality_torch/config4_port`): the port's
  own draws, so the data differs from the JAX package's and only the
  controlled / zero-force ratio compares.

Printed: the card's name and power limit (`nvidia-smi`), each stage's
final training loss and steps/s beside the JAX package's seeds 0, 1 and 2
(`artifacts/runs/{smoke_indirect,shape_transition}{,_s1,_s2}/results.json`),
the eval block (controlled final MSE ± sem, zero force, ratio) beside
theirs, whether the controlled MSE lies within the band around the seeds'
mean (config 4 ±15%, config 3 ±25%) and, with the JAX draws, whether the
zero force matches; the wall time; and last a JSON summary line, also
written to `summary.json` in the run directory. The exit code is 0 once
the run has finished, whatever the comparison says.

With `--draws port --cross-eval`, the run's final networks are evaluated
again on the JAX package's validation set (its draws), which tells a
harder validation set from a worse controller.

`--iterations`, `--e2e-iterations`, `--num-train`, `--num-val` and
`--device` cut a quick check (the comparison is then not meaningful);
with `--draws jax` the counts must be multiples of the draws' chunk of 8.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
RUNS = os.path.join(ROOT, "artifacts", "runs")
# config: (entry, the JAX package's runs of seeds 0, 1, 2, reference
# counts, the band around the seeds' mean controlled MSE)
CONFIGS = {
    "config4": ("smoke_indirect",
                ("smoke_indirect", "smoke_indirect_s1", "smoke_indirect_s2"),
                dict(iterations=4000, e2e_iterations=8000, num_train=512,
                     num_val=32), 0.15),
    "config3": ("shape_transition",
                ("shape_transition", "shape_transition_s1",
                 "shape_transition_s2"),
                dict(iterations=3500, e2e_iterations=None, num_train=512,
                     num_val=32), 0.25),
}
STAGES = ("cfe_supervised", "op2_supervised", "op4_supervised",
          "op8_supervised", "op16_supervised", "end_to_end")
ZERO_FORCE_RTOL = 1e-2
# The draws' arrays a pop returns, by the port's draw function.
DRAW_KEYS = {"inflow": ("xs",), "field": ("amps", "phy", "phx"),
             "shapes": ("pos", "r", "aspect", "is_circle")}


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def patch_draws(config: str) -> dict:
    """Replaces the port's draw functions by pops from the JAX package's
    draws; returns the pops made, by (split, draw function)."""
    import torch

    from pde_control_tpu_torch.data import generate

    z = np.load(os.path.join(GOLDENS, f"jax_draws_{config}.npz"))
    meta = json.loads(str(z["config"]))
    split_of = {v["seed"]: split for split, v in meta["splits"].items()}
    pops: dict = {}

    def pop(gen, kind: str, batch: int):
        split = split_of[gen.initial_seed()]
        if batch != meta["chunk"]:
            raise ValueError(f"a chunk of {batch}: the JAX draws come in "
                             f"chunks of {meta['chunk']}")
        i = pops.get((split, kind), 0)
        pops[split, kind] = i + 1
        return tuple(torch.from_numpy(np.array(z[f"{split}/{k}"][i]))
                     for k in DRAW_KEYS[kind])

    generate.smooth_field_draws = lambda gen, b, modes=3: pop(gen, "field", b)
    if config == "config4":
        generate.inflow_draws = (
            lambda gen, b, w, x_range=(0.15, 0.85): pop(gen, "inflow", b)[0])
    else:
        generate.INITS["shapes"] = (
            lambda gen, b, h, w, *a, **k: pop(gen, "shapes", b),
            generate.shapes_from_draws)
    return pops


def run_jax_draws(config: str, counts: dict, device: str, workdir: str
                  ) -> dict:
    from pde_control_tpu_torch.experiments import fluid2d

    pops = patch_draws(config)
    kw = dict(iterations=counts["iterations"], num_train=counts["num_train"],
              num_val=counts["num_val"], seed=0, device=device)
    if config == "config4":
        results = fluid2d.run_smoke_indirect(
            workdir, e2e_iterations=counts["e2e_iterations"], **kw)
    else:
        results = fluid2d.run_shape_transition(workdir, **kw)
    print(f"draws popped from jax_draws_{config}.npz: "
          f"{ {f'{s}/{k}': n for (s, k), n in sorted(pops.items())} }",
          flush=True)
    return results


def run_cli(config: str, counts: dict, device: str, workdir: str) -> dict:
    entry = CONFIGS[config][0]
    cmd = [sys.executable, "-m", "pde_control_tpu_torch.experiments.run",
           entry, "--iterations", str(counts["iterations"]),
           "--num-train", str(counts["num_train"]), "--workdir", workdir,
           "--device", device]
    if counts["e2e_iterations"]:
        cmd += ["--e2e-iterations", str(counts["e2e_iterations"])]
    if counts["num_val"] != 32:
        cmd += ["--num-val", str(counts["num_val"])]
    print("running:", " ".join(cmd[1:]), flush=True)
    subprocess.run(cmd, cwd=ROOT, check=True, stdout=subprocess.DEVNULL)
    with open(os.path.join(workdir, "results.json")) as f:
        return json.load(f)


def cross_eval(config: str, counts: dict, device: str, workdir: str) -> dict:
    """The eval block of the run's final networks (`workdir/ckpt_final`)
    on the JAX package's validation set, generated here from its draws."""
    from pde_control_tpu_torch import ControlTraining
    from pde_control_tpu_torch.experiments import fluid2d
    from pde_control_tpu_torch.experiments.curriculum import (
        evaluate_control,
        op_spans,
    )

    patch_draws(config)
    # One training chunk: the setups generate a training set too.
    if config == "config4":
        pde, _, val = fluid2d._smoke_indirect_setup(
            64, 16, 8, counts["num_val"], 1.0, None, device=device)
    else:
        pde, _, val = fluid2d._shape_transition_setup(
            64, 16, 8, counts["num_val"], None, device=device)
    app = ControlTraining(
        16, pde, dataset=val, val_dataset=val, batch_size=8,
        trainable_networks=("CFE",) + tuple(f"OP{s}" for s in op_spans(16)),
        sequence_class="staggered", obs_loss_frames=(16,),
        restore=os.path.join(workdir, "ckpt_final")).prepare()
    ev = evaluate_control(app, val, 16)
    mse, zero = ev["final_state_mse"], ev["zero_force_final_mse"]
    print(f"the run's networks on the JAX package's validation set: controlled "
          f"{mse:.4e} ± {ev['final_state_mse_sem']:.2e} (sem), zero force "
          f"{zero:.6e}, ratio {zero / mse:.1f}x", flush=True)
    return dict(final_state_mse=mse, final_state_mse_sem=ev["final_state_mse_sem"],
                zero_force_final_mse=zero, ratio=zero / mse)


def compare(config: str, draws: str, results: dict) -> dict:
    """Prints the port's stages and eval beside the JAX package's seeds;
    returns the summary."""
    _, refs, _, band = CONFIGS[config]
    jax_runs = []
    for name in refs:
        with open(os.path.join(RUNS, name, "results.json")) as f:
            jax_runs.append(json.load(f))
    print(f"{'stage':<16} {'port loss':>12} {'steps/s':>9} "
          + " ".join(f"{'JAX seed ' + str(i):>12}" for i in range(3)))
    for stage in STAGES:
        got = results.get(stage, {})
        print(f"{stage:<16} {got.get('loss', float('nan')):>12.4e} "
              f"{got.get('steps_per_sec', float('nan')):>9.2f} "
              + " ".join(f"{r[stage]['loss']:>12.4e}" for r in jax_runs))
    ev = results["eval"]
    mse, zero = ev["final_state_mse"], ev["zero_force_final_mse"]
    jmse = [r["eval"]["final_state_mse"] for r in jax_runs]
    jzero = jax_runs[0]["eval"]["zero_force_final_mse"]
    mean = float(np.mean(jmse))
    lo, hi = (1 - band) * mean, (1 + band) * mean
    summary = dict(
        config=config, draws=draws,
        final_state_mse=mse, final_state_mse_sem=ev["final_state_mse_sem"],
        zero_force_final_mse=zero, ratio=zero / mse,
        eval_samples=ev["eval_samples"],
        stage_loss={s: results.get(s, {}).get("loss") for s in STAGES},
        jax_final_state_mse=jmse, jax_zero_force_final_mse=jzero,
        jax_ratio=[jzero / m for m in jmse],
        band=[lo, hi], controlled_in_band=bool(lo <= mse <= hi))
    print(f"eval: controlled final MSE {mse:.4e} ± {ev['final_state_mse_sem']:.2e} "
          f"(sem, {ev['eval_samples']} samples), zero force {zero:.6e}, "
          f"ratio {zero / mse:.1f}x")
    print(f"JAX package, seeds 0-2: controlled {[f'{m:.4e}' for m in jmse]}, "
          f"zero force {jzero:.6e}, ratios "
          f"{[f'{jzero / m:.1f}x' for m in jmse]}")
    print(f"controlled within ±{band:.0%} of the seeds' mean {mean:.4e} "
          f"[{lo:.3e}, {hi:.3e}]: {summary['controlled_in_band']}")
    if draws == "jax":
        rel = abs(zero - jzero) / jzero
        summary.update(zero_force_rel_err=rel,
                       zero_force_matches=bool(rel <= ZERO_FORCE_RTOL))
        print(f"zero force against the JAX package's: {rel:.3e} relative "
              f"(limit {ZERO_FORCE_RTOL:g}): {summary['zero_force_matches']}")
    return summary


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config", choices=sorted(CONFIGS))
    p.add_argument("--draws", choices=("jax", "port"), default="jax")
    p.add_argument("--device", default="cuda")
    p.add_argument("--cross-eval", action="store_true",
                   help="with --draws port, also evaluate the run's final "
                        "networks on the JAX package's validation set")
    for flag in ("iterations", "e2e_iterations", "num_train", "num_val"):
        p.add_argument(f"--{flag.replace('_', '-')}", type=int, default=None)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    counts = dict(CONFIGS[args.config][2])
    for k in counts:
        if getattr(args, k) is not None:
            counts[k] = getattr(args, k)
    print(card_line(), flush=True)
    print(f"{args.config}, draws {args.draws}, counts {counts}, device "
          f"{args.device}", flush=True)
    workdir = os.path.join(ROOT, "runs", "quality_torch",
                           f"{args.config}_{args.draws}")
    t0 = time.perf_counter()
    run = run_jax_draws if args.draws == "jax" else run_cli
    results = run(args.config, counts, args.device, workdir)
    wall = time.perf_counter() - t0
    summary = compare(args.config, args.draws, results)
    summary.update(wall_s=wall, counts=counts, card=card_line())
    if args.cross_eval and args.draws == "port":
        summary["on_jax_val"] = cross_eval(args.config, counts, args.device,
                                           workdir)
    print(f"wall time {wall:.1f} s", flush=True)
    with open(os.path.join(workdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
