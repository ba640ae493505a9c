"""Execution-scheme comparison — the paper's core result table: CFE chain
(greedy) vs staggered vs prediction-refinement vs the classical adjoint
baseline, on Burgers (N=32, n=32) and 2D smoke (64², n=16), reporting
final-state MSE and mean |F| per scheme.

Counterpart of `pde_control_tpu/experiments/compare_schemes.py`, with the
same protocol, rows, keys and resume rules:
  1. generate train/val datasets (withheld forcing, non-degenerate);
  2. shared CFE supervised stage + shared per-level OP supervised stages;
  3. per scheme: end-to-end stage restoring the shared checkpoints;
  4. eval on ONE fixed val batch: controlled final MSE, mean |F|,
     zero-force baseline MSE;
  5. adjoint: per-trajectory direct force optimization on the same batch
     (control/adjoint.py — no networks, the paper's comparator).
`comparison.json` is rewritten after every completed row. Each entry
takes `device` (the card unless given). Each stage's app is closed once
its checkpoint is written, so that its captured step graph does not hold
device memory into the next stage.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from pde_control_tpu_torch.control.adjoint import optimize_forces
from pde_control_tpu_torch.control.training import ControlTraining
from pde_control_tpu_torch.experiments.curriculum import (
    _ckpt_has,
    _force_at,
    autosave_kwargs,
    clear_autosave,
    evaluate_control,
    op_spans,
    zero_force_baseline,
)
from pde_control_tpu_torch.utils.epoch import vm_epoch

SCHEMES = ("chain_final", "staggered", "refined")


def _eval_batch(val_dataset):
    """Deterministic prefix of the val set (no replacement) for the
    adjoint/zero-force rows: the scheme rows evaluate the full val set in
    order (evaluate_control), so with val sets ≤ 32 every row scores the
    same trajectories."""
    return val_dataset.take(np.arange(min(len(val_dataset), 32)))


def _adjoint_row(pde, batch: dict, n: int, iterations: int, lr: float,
                 force_reg: float, microbatch: int | None) -> dict:
    """The adjoint row: `optimize_forces` on each `microbatch`-sized chunk
    of `batch` (the whole batch by default; equal chunks share one
    program, a short tail is dropped), weighted by chunk size."""
    nb = int(next(iter(batch.values())).shape[0])
    mb = microbatch or nb
    chunk_mse, chunk_force, chunk_cost, sizes = [], [], [], []
    for lo in range(0, nb, mb):
        part = {k: torch.as_tensor(np.asarray(v[lo:lo + mb]),
                                   dtype=torch.float32, device=pde.device)
                for k, v in batch.items()}
        if int(part["obs"].shape[0]) != mb:
            continue  # val sizes are multiples of mb in practice
        forces, hist = optimize_forces(
            pde, pde.initial_state(part), part["obs"][:, n], n=n,
            iterations=iterations, learning_rate=lr, force_reg=force_reg)
        abs_means = torch.stack([pde.force_abs_mean(_force_at(forces, t))
                                 for t in range(n)])
        chunk_mse.append(float(hist["obs_loss"][-1]))
        chunk_force.append(float(torch.mean(abs_means)))
        chunk_cost.append(float(hist["force_cost"][-1]))
        sizes.append(mb)
    wts = np.asarray(sizes, np.float64) / max(sum(sizes), 1)
    return {
        "final_state_mse": float(np.asarray(chunk_mse) @ wts),
        "final_state_mse_sem": float(
            np.std(chunk_mse) / max(len(chunk_mse) - 1, 1) ** 0.5),
        "mean_abs_force": float(np.asarray(chunk_force) @ wts),
        "mean_force_cost": float(np.asarray(chunk_cost) @ wts),
        "iterations": iterations,
        "microbatch": mb,
        "num_trajectories": int(sum(sizes)),
    }


def run_comparison(
    pde,
    n: int,
    dataset,
    val_dataset,
    workdir: str,
    batch_size: int = 8,
    iterations: int = 500,
    force_reg: float = 1e-3,
    steps_per_call: int = 8,
    adjoint_iterations: int = 500,
    adjoint_lr: float = 0.05,
    adjoint_microbatch: int | None = None,
    grad_clip: float | None = 1.0,  # unclipped e2e runs diverged; None
    # opts out explicitly
    seed: int = 0,
    resume: bool = False,
) -> dict:
    os.makedirs(workdir, exist_ok=True)
    common = dict(pde=pde, dataset=dataset, val_dataset=val_dataset,
                  batch_size=batch_size, force_reg=force_reg,
                  grad_clip=grad_clip, seed=seed)

    # Incremental results + stage-granular resume: comparison.json is
    # rewritten after every completed row, so a killed comparison rerun
    # with resume=True skips finished supervised stages, scheme rows, and
    # the adjoint/zero-force rows; train() autosaves cover mid-stage kills.
    out_path = os.path.join(workdir, "comparison.json")
    results: dict = {}
    if resume and os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)

    def _flush():
        # The file-level epoch records the run that wrote the last row.
        results.setdefault("vm_epoch", vm_epoch())
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2, default=float)

    def _saved(ckpt: str, *nets: str) -> bool:
        return resume and _ckpt_has(ckpt, *nets)

    def _autosave_kw(tag: str) -> dict:
        return autosave_kwargs(workdir, tag, 500, resume)

    # --- shared supervised stages -------------------------------------------
    # Skipped entirely when every scheme row is already in comparison.json:
    # a resume that only needs the adjoint/zero-force rows (which use no
    # networks) must not retrain supervised stages whose checkpoints are
    # gone.
    schemes_done = resume and all(s in results for s in SCHEMES)
    cfe_dir = os.path.join(workdir, "ckpt_cfe")
    if not schemes_done and not _saved(cfe_dir, "CFE"):
        app = ControlTraining(
            n, trainable_networks=("CFE",), sequence_class="chain",
            obs_loss_frames=tuple(range(1, n + 1)),
            logdir=os.path.join(workdir, "logs_cfe"), **common,
        ).prepare()
        app.train(iterations, steps_per_call=steps_per_call,
                  **_autosave_kw("cfe"))
        app.save(cfe_dir)
        app.close()
        clear_autosave(workdir, "cfe")

    ops_dir = os.path.join(workdir, "ckpt_ops")
    for span in sorted(op_spans(n)):
        if schemes_done or _saved(ops_dir, f"OP{span}"):
            continue
        app = ControlTraining(
            n, trainable_networks=(f"OP{span}",),
            sequence_class="op_supervised",
            restore=ops_dir if os.path.isdir(ops_dir) else None,
            logdir=os.path.join(workdir, f"logs_op{span}"), **common,
        ).prepare()
        app.train(iterations, steps_per_call=steps_per_call,
                  **_autosave_kw(f"op{span}"))
        # names=: writing every net would add later spans at random init,
        # and the resume skip above would take them for trained.
        app.save(ops_dir, names=(f"OP{span}",))
        app.close()
        clear_autosave(workdir, f"op{span}")

    # --- per-scheme end-to-end ------------------------------------------------
    batch = _eval_batch(val_dataset)
    for scheme in SCHEMES:
        if resume and scheme in results:
            clear_autosave(workdir, f"e2e_{scheme}")
            continue
        trainable = ("CFE",)
        restore = {"CFE": cfe_dir}
        if scheme != "chain_final":
            trainable += tuple(f"OP{s}" for s in op_spans(n))
            restore.update({f"OP{s}": ops_dir for s in op_spans(n)})
        scheme_ckpt = os.path.join(workdir, f"ckpt_{scheme}")
        # Killed between the scheme checkpoint and its eval row reaching
        # comparison.json: restore the trained nets and re-run only the
        # eval, not the e2e stage.
        trained = _saved(scheme_ckpt, *trainable)
        if trained:
            restore = {net: scheme_ckpt for net in trainable}
        app = ControlTraining(
            n, trainable_networks=trainable, sequence_class=scheme,
            obs_loss_frames=(n,), restore=restore, learning_rate=3e-4,
            logdir=os.path.join(workdir, f"logs_e2e_{scheme}"), **common,
        ).prepare()
        if not trained:
            app.train(iterations, steps_per_call=steps_per_call,
                      **_autosave_kw(f"e2e_{scheme}"))
            app.save(scheme_ckpt)
        app.close()
        clear_autosave(workdir, f"e2e_{scheme}")
        results[scheme] = evaluate_control(app, val_dataset, n)
        _flush()

    # --- adjoint baseline (direct optimization, no networks) ------------------
    # The adjoint optimizes the PDE's full force — for the indirect smoke
    # task a direct staggered force, strictly more authority than the
    # buoyancy-only CFE: the upper-bound comparator the paper uses.
    adjoint_done = (resume and isinstance(results.get("adjoint"), dict)
                    and not results["adjoint"].get("skipped"))
    if adjoint_iterations <= 0:
        # Explicitly skippable: the heaviest single program of the
        # comparison.
        if not adjoint_done:
            results["adjoint"] = {"skipped": True,
                                  "reason": "adjoint_iterations<=0"}
    elif not adjoint_done:
        # Microbatching divides the peak memory by batch/microbatch at no
        # protocol cost: the adjoint optimizes each trajectory
        # independently (per-sample loss terms).
        results["adjoint"] = _adjoint_row(pde, batch, n, adjoint_iterations,
                                          adjoint_lr, force_reg,
                                          adjoint_microbatch)
        _flush()
    if not (resume and "zero_force" in results):
        # The zero-force rollout uses no network output; restore the CFE
        # only when its checkpoint survives.
        app_any = ControlTraining(
            n, trainable_networks=("CFE",), sequence_class="chain_final",
            restore={"CFE": cfe_dir} if os.path.isdir(cfe_dir) else None,
            **common).prepare()
        natural = zero_force_baseline(app_any, batch)
        results["zero_force"] = {
            "final_state_mse": float(np.mean(
                (natural - np.asarray(batch["obs"][:, n])) ** 2)),
        }
    _flush()
    return results


def compare_burgers(workdir: str, n: int = 32, iterations: int = 1000,
                    num_train: int = 1024, num_val: int = 128,
                    batch_size: int = 32, smoke_test: bool = False,
                    resume: bool = False, device=None) -> dict:
    from pde_control_tpu_torch.control.pde_burgers import BurgersPDE
    from pde_control_tpu_torch.data.generate import generate_burgers_dataset
    from pde_control_tpu_torch.experiments.burgers import BURGERS_CFG

    if smoke_test:
        n, iterations, num_train, num_val, batch_size = 4, 20, 32, 16, 8
    cfg = BURGERS_CFG
    pde = BurgersPDE(cfg, device=device)
    train = generate_burgers_dataset(cfg, num_train, n, seed=0,
                                     force_amplitude=0.5, device=pde.device)
    val = generate_burgers_dataset(cfg, num_val, n, seed=999,
                                   force_amplitude=0.5, device=pde.device)
    return run_comparison(pde, n, train, val, workdir,
                          batch_size=batch_size, iterations=iterations,
                          force_reg=1e-4, adjoint_lr=0.1, resume=resume)


def compare_smoke(workdir: str, size: int = 64, n: int = 16,
                  iterations: int = 500, num_train: int = 256,
                  num_val: int = 32, batch_size: int = 8,
                  smoke_test: bool = False,
                  control_amplitude: float = 0.6,
                  grad_clip: float | None = None,
                  adjoint_iterations: int = 300,
                  adjoint_microbatch: int | None = None,
                  resume: bool = False, device=None) -> dict:
    from pde_control_tpu_torch.control.pde_fluid import IncompressibleFluidPDE
    from pde_control_tpu_torch.data.generate import (
        generate_inflow_smoke_dataset,
    )
    from pde_control_tpu_torch.experiments.fluid2d import default_obstacles
    from pde_control_tpu_torch.grids import Domain2D
    from pde_control_tpu_torch.physics.fluid import FluidConfig

    if smoke_test:
        size, n, iterations, num_train, num_val, batch_size = 16, 4, 10, 16, 8, 4
    domain = Domain2D.create(size, size,
                             obstacle_mask=default_obstacles(size, size),
                             device=device)
    cfg = FluidConfig(dt=1.0, buoyancy=0.08, pressure_tol=1e-4,
                      pressure_maxiter=200, warm_start_pressure=True)
    train = generate_inflow_smoke_dataset(domain, cfg, num_train, n, seed=0,
                                          control_amplitude=control_amplitude)
    val = generate_inflow_smoke_dataset(domain, cfg, num_val, n, seed=999,
                                        control_amplitude=control_amplitude)
    pde = IncompressibleFluidPDE(domain, cfg, control="buoyancy",
                                 with_inflow=True,
                                 unet_levels=3 if size >= 32 else 2)
    # force_reg 3e-4: with force_cost ≈ 0.2 a larger weight's reg term
    # rivals the observation MSE and caps the achievable control.
    return run_comparison(pde, n, train, val, workdir,
                          batch_size=batch_size, iterations=iterations,
                          force_reg=3e-4, adjoint_lr=0.5,
                          adjoint_iterations=adjoint_iterations,
                          adjoint_microbatch=adjoint_microbatch,
                          grad_clip=grad_clip, resume=resume)


def compare_smoke_long(workdir: str, iterations: int = 1500,
                       smoke_test: bool = False,
                       resume: bool = False, device=None) -> dict:
    """The hierarchy demonstration at long horizon: smoke at n=32, the
    control amplitude horizon-scaled (0.3 against 0.6 at n=16) so that the
    accumulated buoyancy-driven velocities stay inside the max_shift CFL
    bound, and the e2e stages clipped."""
    if smoke_test:
        return compare_smoke(workdir, smoke_test=True, device=device)
    return compare_smoke(workdir, n=32, iterations=iterations,
                         control_amplitude=0.3, grad_clip=1.0,
                         resume=resume, device=device)


def compare_smoke_64(workdir: str, iterations: int = 1500,
                     smoke_test: bool = False,
                     resume: bool = False, device=None) -> dict:
    """The hierarchy demonstration at n=64 (2× compare_smoke_long's
    horizon), the amplitude continuing the horizon scaling (0.15), and
    the adjoint in microbatches of 4 trajectories."""
    if smoke_test:
        return compare_smoke(workdir, smoke_test=True, device=device)
    return compare_smoke(workdir, n=64, iterations=iterations,
                         control_amplitude=0.15, grad_clip=1.0,
                         adjoint_iterations=300, adjoint_microbatch=4,
                         resume=resume, device=device)
