"""The staged training curriculum as a reusable runner.

Counterpart of `pde_control_tpu/experiments/curriculum.py`. Stages compose
through per-network checkpoints, which the JAX package reads too:
  1. CFE supervised — chain sequence against ground-truth next frames.
  2. OPk supervised — per hierarchy level, dataset triples, no solver.
  3. End-to-end — staggered (or refined) sequence, all networks trainable,
     restoring stages 1-2; optional staged growth of n.
  4. Eval — infer_all_frames on validation → final-state MSE + mean force.

Each stage's app is closed (`ControlTraining.close`) once its checkpoint is
written, so that its captured step graph does not hold device memory into
the next stage.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch

from pde_control_tpu_torch.control.pde_base import PDE
from pde_control_tpu_torch.control.training import ControlTraining
from pde_control_tpu_torch.utils.epoch import stamp
from pde_control_tpu_torch.utils.viz import save_comparison_png, save_field_png


@dataclasses.dataclass
class CurriculumConfig:
    n: int
    batch_size: int = 16
    cfe_iterations: int = 1000
    op_iterations: int = 1000
    e2e_iterations: int = 1000
    cfe_lr: float = 1e-3
    op_lr: float = 1e-3
    e2e_lr: float = 3e-4
    force_reg: float = 1e-3
    e2e_sequence: str = "staggered"  # or 'refined'
    # Staged horizon growth for stage 3 (8→16→…→n); None = full n directly.
    e2e_stage_ns: tuple | None = None
    # Global-norm gradient clip, on by default: unclipped solver-in-the-loop
    # e2e stages diverge. None opts out.
    grad_clip: float | None = 1.0
    seed: int = 0
    # Optimizer steps per progress_multi call (train(steps_per_call=k)).
    steps_per_call: int = 8
    # LR schedule for the e2e stage ('cosine' decays over the stage's
    # iteration count); supervised stages keep a constant LR.
    e2e_lr_schedule: str | None = "cosine"
    # Mid-stage crash recovery: every `autosave_every` optimizer steps the
    # stage autosaves its full training state; run_curriculum(resume=True)
    # restores it and finishes the interrupted stage. 0 disables.
    autosave_every: int = 500
    # Observation-loss frames for the e2e stage. None = final frame only;
    # a tuple adds intermediate ground-truth frames (frames beyond the
    # current staged horizon n_k are dropped, n_k always kept).
    e2e_obs_frames: tuple | None = None


def op_spans(n: int) -> list[int]:
    out = []
    while n >= 2:
        out.append(n)
        n //= 2
    return out


def _ckpt_has(ckpt_dir: str, *names: str) -> bool:
    """True when `ckpt_dir` holds a msgpack for every named network."""
    return all(os.path.exists(os.path.join(ckpt_dir, f"{n}.msgpack"))
               for n in names)


def autosave_kwargs(workdir: str, tag: str, every: int,
                    restore: bool) -> dict:
    """train() kwargs for mid-stage crash recovery: autosave the full
    training state every `every` steps; restore an existing autosave when
    resuming. 0 disables."""
    if not every:
        return {}
    return dict(autosave_dir=os.path.join(workdir, f"autosave_{tag}"),
                autosave_every=every, autosave_restore=restore)


def clear_autosave(workdir: str, tag: str) -> None:
    """Drop a stage's autosave (and any swap leftovers) once the stage
    checkpoint is written — and also when a resumed run skips the stage,
    so that a stale autosave is not restored if the stage checkpoint is
    later deleted to force a retrain."""
    for suffix in ("", ".old", ".tmp"):
        shutil.rmtree(os.path.join(workdir, f"autosave_{tag}{suffix}"),
                      ignore_errors=True)


def _e2e_frames(cfg: CurriculumConfig, n_k: int) -> tuple:
    if cfg.e2e_obs_frames:
        return tuple(sorted({f for f in cfg.e2e_obs_frames if f < n_k}
                            | {n_k}))
    return (n_k,)


def _write_results(workdir: str, results: dict) -> None:
    stamp(results)  # dataset epoch: cross-wipe MSEs compare by ratio only
    with open(os.path.join(workdir, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)


def run_curriculum(
    pde: PDE,
    cfg: CurriculumConfig,
    dataset,
    val_dataset,
    workdir: str,
    mesh=None,
    skip_cfe: bool = False,
    resume: bool = False,
) -> dict:
    """Stages 1–4 (module docstring) in `workdir`; writes results.json.

    With `resume`, stages whose checkpoint already exists in `workdir` are
    skipped (their results entry is {"resumed": True}) and an interrupted
    stage restarts from its autosave."""
    if cfg.e2e_stage_ns and cfg.e2e_stage_ns[-1] != cfg.n:
        raise ValueError(
            f"e2e_stage_ns must end at n={cfg.n} (got {cfg.e2e_stage_ns}) — "
            "the final eval compares frame n of the last-stage model")
    os.makedirs(workdir, exist_ok=True)
    results: dict = {}

    def stage_dir(name: str) -> str:
        return os.path.join(workdir, name)

    common = dict(pde=pde, dataset=dataset, val_dataset=val_dataset,
                  batch_size=cfg.batch_size, mesh=mesh,
                  force_reg=cfg.force_reg, grad_clip=cfg.grad_clip,
                  seed=cfg.seed)

    def autosave_kw(tag: str) -> dict:
        return autosave_kwargs(workdir, tag, cfg.autosave_every, resume)

    # ---- stage 1: CFE supervised (chain, all-frames loss) -----------------
    cfe_done = (resume and not skip_cfe
                and _ckpt_has(stage_dir("ckpt_cfe"), "CFE"))
    if cfe_done:
        results["cfe_supervised"] = {"resumed": True}
        clear_autosave(workdir, "cfe")
    if not skip_cfe and not cfe_done:
        app = ControlTraining(
            cfg.n, trainable_networks=("CFE",), sequence_class="chain",
            obs_loss_frames=tuple(range(1, cfg.n + 1)),
            learning_rate=cfg.cfe_lr,
            logdir=stage_dir("logs_cfe"), **common,
        ).prepare()
        results["cfe_supervised"] = app.train(
            cfg.cfe_iterations, steps_per_call=cfg.steps_per_call,
            **autosave_kw("cfe"))
        app.save(stage_dir("ckpt_cfe"))
        app.close()
        clear_autosave(workdir, "cfe")

    # ---- stage 2: per-level OP supervised ---------------------------------
    for span in sorted(op_spans(cfg.n)):
        if resume and _ckpt_has(stage_dir("ckpt_ops"), f"OP{span}"):
            results[f"op{span}_supervised"] = {"resumed": True}
            clear_autosave(workdir, f"op{span}")
            continue
        app = ControlTraining(
            cfg.n, trainable_networks=(f"OP{span}",),
            sequence_class="op_supervised", learning_rate=cfg.op_lr,
            restore=stage_dir("ckpt_ops") if span > 2 and
            os.path.isdir(stage_dir("ckpt_ops")) else None,
            logdir=stage_dir(f"logs_op{span}"), **common,
        ).prepare()
        results[f"op{span}_supervised"] = app.train(
            cfg.op_iterations, steps_per_call=cfg.steps_per_call,
            **autosave_kw(f"op{span}"))
        # Only this stage's net goes into the shared ckpt_ops: the later
        # spans, still at random init, would pass for finished stages.
        app.save(stage_dir("ckpt_ops"), names=(f"OP{span}",))
        app.close()
        clear_autosave(workdir, f"op{span}")

    # ---- stage 3: end-to-end (optionally staged horizon growth) -----------
    stage_ns = tuple(cfg.e2e_stage_ns) if cfg.e2e_stage_ns else (cfg.n,)
    prev_ckpt = None
    for n_k in stage_ns:
        ck = stage_dir(f"ckpt_e2e_n{n_k}")
        stage_done = (resume and _ckpt_has(
            ck, "CFE", *(f"OP{s}" for s in op_spans(n_k))))
        if stage_done:
            results[f"end_to_end_n{n_k}"] = {"resumed": True}
            clear_autosave(workdir, f"e2e_n{n_k}")
            prev_ckpt = ck
            if n_k != stage_ns[-1]:
                continue
            # The final stage is trained: its app is still built, restored
            # from its own checkpoint, for stage 4's eval.
        # Each network restores from the newest checkpoint that has it:
        # the previous horizon's when available, else the supervised
        # stages' (a larger n_k brings a new top-level OP{n_k}).
        restore = {}
        if not skip_cfe or prev_ckpt:
            restore["CFE"] = prev_ckpt or stage_dir("ckpt_cfe")
        for span in op_spans(n_k):
            name = f"OP{span}"
            if prev_ckpt and os.path.exists(
                    os.path.join(prev_ckpt, f"{name}.msgpack")):
                restore[name] = prev_ckpt
            else:
                restore[name] = stage_dir("ckpt_ops")
        trainable = ("CFE",) + tuple(f"OP{s}" for s in op_spans(n_k))
        app = ControlTraining(
            n_k, trainable_networks=trainable,
            sequence_class=cfg.e2e_sequence,
            obs_loss_frames=_e2e_frames(cfg, n_k),
            learning_rate=cfg.e2e_lr, restore=restore,
            lr_schedule=cfg.e2e_lr_schedule,
            decay_steps=cfg.e2e_iterations if cfg.e2e_lr_schedule else None,
            logdir=stage_dir(f"logs_e2e_n{n_k}"), **common,
        ).prepare()
        if not stage_done:
            results[f"end_to_end_n{n_k}"] = app.train(
                cfg.e2e_iterations, steps_per_call=cfg.steps_per_call,
                **autosave_kw(f"e2e_n{n_k}"))
            prev_ckpt = ck
            app.save(prev_ckpt)
            clear_autosave(workdir, f"e2e_n{n_k}")
        app.close()
    results["end_to_end"] = results[f"end_to_end_n{stage_ns[-1]}"]
    app.save(stage_dir("ckpt_final"))

    # ---- stage 4: eval ----------------------------------------------------
    results["eval"] = evaluate_control(app, val_dataset, cfg.n,
                                       render_dir=workdir)
    _write_results(workdir, results)
    return results


def finetune_e2e(
    pde: PDE,
    cfg: CurriculumConfig,
    dataset,
    val_dataset,
    workdir: str,
    init_ckpt: str,
    mesh=None,
    resume: bool = False,
) -> dict:
    """One extra end-to-end stage on top of a finished curriculum run.

    Restores every network (CFE + all OP spans of cfg.n) from `init_ckpt`
    — typically another run's `ckpt_final`, of either package — and
    trains them jointly at this config's force_reg/lr (force-reg
    annealing). `resume` skips the stage when `ckpt_final` already exists
    and restores mid-stage autosaves otherwise. Writes results.json with
    the standard eval block.
    """
    needed = ("CFE",) + tuple(f"OP{s}" for s in op_spans(cfg.n))
    if not _ckpt_has(init_ckpt, *needed):
        raise FileNotFoundError(
            f"init_ckpt {init_ckpt!r} is missing one of {needed} — "
            "point --init-from at a finished run's ckpt_final")
    os.makedirs(workdir, exist_ok=True)
    results: dict = {"init_ckpt": init_ckpt, "force_reg": cfg.force_reg}
    ck = os.path.join(workdir, "ckpt_final")
    stage_done = resume and _ckpt_has(ck, *needed)
    app = ControlTraining(
        cfg.n, trainable_networks=needed,
        sequence_class=cfg.e2e_sequence,
        obs_loss_frames=_e2e_frames(cfg, cfg.n),
        learning_rate=cfg.e2e_lr,
        restore={name: (ck if stage_done else init_ckpt) for name in needed},
        lr_schedule=cfg.e2e_lr_schedule,
        decay_steps=cfg.e2e_iterations if cfg.e2e_lr_schedule else None,
        logdir=os.path.join(workdir, "logs_ft"),
        pde=pde, dataset=dataset, val_dataset=val_dataset,
        batch_size=cfg.batch_size, mesh=mesh, force_reg=cfg.force_reg,
        grad_clip=cfg.grad_clip, seed=cfg.seed,
    ).prepare()
    if stage_done:
        results["finetune"] = {"resumed": True}
    else:
        results["finetune"] = app.train(
            cfg.e2e_iterations, steps_per_call=cfg.steps_per_call,
            **autosave_kwargs(workdir, "ft", cfg.autosave_every, resume))
        app.save(ck)
    clear_autosave(workdir, "ft")
    app.close()
    results["eval"] = evaluate_control(app, val_dataset, cfg.n,
                                       render_dir=workdir)
    _write_results(workdir, results)
    return results


def zero_force_baseline(app: ControlTraining, batch,
                        all_frames: bool = False) -> np.ndarray:
    """Observation(s) of the uncontrolled rollout from the same initial
    state — the degenerate controller every result must beat. Returns the
    final observation, or the whole (n, B, *s, C) trajectory with
    all_frames."""
    pde = app.pde
    with torch.no_grad():
        state = pde.initial_state(app.to_batch(batch))
        frames = []
        for _ in range(app.n):
            state = pde.step(state, None)
            if all_frames:
                frames.append(pde.observe(state))
        out = torch.stack(frames) if all_frames else pde.observe(state)
    return out.cpu().numpy()


def _force_at(forces, t: int):
    """Step t's force from a force stacked along a leading time axis."""
    return dataclasses.replace(forces, **{
        f.name: getattr(forces, f.name)[t]
        for f in dataclasses.fields(forces)})


def evaluate_control(app: ControlTraining, val_dataset, n: int,
                     render_dir: str | None = None,
                     eval_batch: int = 16, render_samples: int = 4) -> dict:
    """Final-state MSE vs ground truth, mean |F| (the paper's force metric),
    force cost, and the zero-force baseline MSE.

    Evaluates the whole validation set in deterministic `eval_batch`-sized
    chunks (a sub-size tail is dropped, the evaluated count reported),
    reports the per-sample spread of the final MSE, and per-frame error
    curves for both the controlled and the zero-force rollout. The
    rollouts are eager and without gradients (`infer_all_frames`)."""
    if n != app.n:
        raise ValueError(f"eval n={n} != model horizon {app.n}")
    num = len(val_dataset)
    eval_batch = min(eval_batch, num)
    n_chunks = max(num // eval_batch, 1)
    per_sample_mse = []          # (num,) final-frame MSE per trajectory
    per_sample_zero_mse = []
    frame_sse = np.zeros(n)      # summed per-frame squared error
    frame_sse_zero = np.zeros(n)
    frame_count = 0
    cost_sums = []
    absf_means = []
    first_chunk = None
    for c in range(n_chunks):
        idx = np.arange(c * eval_batch, (c + 1) * eval_batch)
        batch = val_dataset.take(idx)
        obs_traj, costs, _final, forces = app.infer_all_frames(
            batch, keep_forces=True)
        obs_traj = obs_traj.cpu().numpy()                   # (n, B, *s, C)
        gt = torch.as_tensor(batch["obs"]).cpu().numpy()    # (B, n+1, *s, C)
        natural = zero_force_baseline(app, batch, all_frames=True)
        sp_axes = tuple(range(1, gt.ndim - 1))  # spatial+channel of (B, …)
        err = obs_traj - np.moveaxis(gt[:, 1:n + 1], 1, 0)
        err_zero = natural - np.moveaxis(gt[:, 1:n + 1], 1, 0)
        per_sample_mse.append(np.mean(err[n - 1] ** 2, axis=sp_axes))
        per_sample_zero_mse.append(
            np.mean(err_zero[n - 1] ** 2, axis=sp_axes))
        # err is (n, B, *spatial, C): mean over the spatial/channel axes,
        # sum over the batch, so frame_sse / frame_count is the per-frame
        # mean and per_frame_mse[-1] equals final_state_mse.
        fr_axes = tuple(range(2, err.ndim))
        frame_sse += np.sum(np.mean(err ** 2, axis=fr_axes), axis=1)
        frame_sse_zero += np.sum(np.mean(err_zero ** 2, axis=fr_axes),
                                 axis=1)
        frame_count += err.shape[1]
        cost_sums.append(np.sum(costs.cpu().numpy(), axis=0))
        absf_means.append(torch.stack([
            app.pde.force_abs_mean(_force_at(forces, t))
            for t in range(n)]).cpu().numpy())              # (n, B)
        if first_chunk is None:
            first_chunk = (obs_traj, gt, natural)
    per_sample_mse = np.concatenate(per_sample_mse)
    per_sample_zero_mse = np.concatenate(per_sample_zero_mse)
    out = {
        "final_state_mse": float(np.mean(per_sample_mse)),
        "final_state_mse_std": float(np.std(per_sample_mse)),
        "final_state_mse_sem": float(
            np.std(per_sample_mse) / np.sqrt(len(per_sample_mse))),
        "mean_force_cost": float(np.mean(np.concatenate(cost_sums))),
        "mean_abs_force": float(np.mean(np.concatenate(absf_means, axis=1))),
        "zero_force_final_mse": float(np.mean(per_sample_zero_mse)),
        "zero_force_final_mse_std": float(np.std(per_sample_zero_mse)),
        "eval_samples": int(frame_count),
        "val_set_size": int(num),
        "per_frame_mse": (frame_sse / frame_count).tolist(),
        "per_frame_zero_force_mse": (frame_sse_zero / frame_count).tolist(),
    }
    obs_traj, gt, natural = first_chunk
    if render_dir and obs_traj.ndim in (5, 6) and obs_traj.shape[2] > 1:
        for s in range(min(render_samples, obs_traj.shape[1])):
            save_comparison_png(
                {"controlled final": obs_traj[n - 1, s, ..., 0],
                 "target": gt[s, n, ..., 0],
                 "zero force": natural[n - 1, s, ..., 0]},
                os.path.join(render_dir, f"eval_sample{s}.png"))
        for tag, field in [("controlled_final", obs_traj[n - 1, 0, ..., 0]),
                           ("target", gt[0, n, ..., 0]),
                           ("zero_force_final", natural[n - 1, 0, ..., 0])]:
            save_field_png(field, os.path.join(render_dir, f"eval_{tag}.png"),
                           title=tag)
    return out
