"""Out-of-distribution generalization evals.

Counterpart of `pde_control_tpu/experiments/generalize.py`, with the same
rows, seeds and `results.json` keys. Every benchmark eval draws its
validation trajectories from the generator that made the training data;
these entries evaluate TRAINED controllers (restored from a finished run's
`ckpt_final`, written by either package) on held-out axes:

  * generalize_shapes — the config-3 (shape transition) controller on
    withheld shape families: crosses (union of boxes) and rings (hollow
    topology). Training saw circles and boxes only, at the same physics
    and forcing.
  * generalize_smoke — the config-4 (indirect smoke) controller on (a) an
    unseen obstacle course (the net sees the new mask through its
    fluid-mask input channel), (b) shifted inflow positions (emitter
    x-range and height outside the training draw), and (c) longer horizons
    (the n=16 CFE chained out to n=24/32; the OPs are per horizon, so the
    horizon rows are the CFE's).

Each row reports the controlled final MSE, the zero-force baseline on the
same out-of-distribution data, and their ratio; the in-distribution row is
evaluated by the same protocol for reference. Every entry runs on `device`
(the card when None).
"""

from __future__ import annotations

import json
import os

import numpy as np

from pde_control_tpu_torch.control.pde_fluid import IncompressibleFluidPDE
from pde_control_tpu_torch.control.training import ControlTraining
from pde_control_tpu_torch.data.generate import (
    generate_forced_smoke_dataset,
    generate_inflow_smoke_dataset,
)
from pde_control_tpu_torch.experiments.curriculum import (
    evaluate_control,
    op_spans,
    zero_force_baseline,
)
from pde_control_tpu_torch.experiments.fluid2d import default_obstacles
from pde_control_tpu_torch.geom import Box, rasterize, union
from pde_control_tpu_torch.grids import Domain2D, resolve_device
from pde_control_tpu_torch.physics.fluid import FluidConfig
from pde_control_tpu_torch.utils.viz import save_comparison_png


def _eval_app(pde, n, dataset, restore_map, sequence_class, batch_size=8,
              seed=0):
    nets = tuple(restore_map)
    return ControlTraining(
        n, pde=pde, dataset=dataset, val_dataset=dataset,
        batch_size=batch_size, trainable_networks=nets,
        sequence_class=sequence_class, obs_loss_frames=(n,),
        restore=restore_map, seed=seed,
    ).prepare()


def _row(app, val, n):
    r = evaluate_control(app, val, n)
    r["ratio_vs_zero_force"] = (
        r["zero_force_final_mse"] / max(r["final_state_mse"], 1e-30))
    return r


def _render_worst(app, val, n, outdir, tag, k=4, chunk=16):
    """Render the k worst-controlled validation samples (controlled final
    beside target and zero force) as `worst_{tag}_{rank}.png`. Returns the
    worst indices (per-sample final MSE, descending)."""
    chunk = min(chunk, len(val))
    mses, finals, targets, zeros = [], [], [], []
    # Cover the whole set: fixed-size chunks, with a last end-aligned chunk
    # for any tail; overlapping indices are dropped, so no sample escapes
    # the worst-k scan.
    starts = list(range(0, len(val) - chunk + 1, chunk))
    if starts[-1] + chunk < len(val):
        starts.append(len(val) - chunk)
    seen: set[int] = set()
    for lo in starts:
        idx = [i for i in range(lo, lo + chunk) if i not in seen]
        seen.update(idx)
        keep = np.asarray([i - lo for i in idx])
        batch = val.take(np.arange(lo, lo + chunk))
        obs_traj, _costs, _final = app.infer_all_frames(batch)
        gt = np.asarray(batch["obs"])
        final = obs_traj.cpu().numpy()[n - 1]
        err = final - gt[:, n]
        mses.append(np.mean(err ** 2,
                            axis=tuple(range(1, err.ndim)))[keep])
        finals.append(final[keep])
        targets.append(gt[keep, n])
        zeros.append(zero_force_baseline(app, batch)[keep])
    mses = np.concatenate(mses)
    finals = np.concatenate(finals)
    targets = np.concatenate(targets)
    zeros = np.concatenate(zeros)
    worst = np.argsort(mses)[::-1][:k]
    os.makedirs(outdir, exist_ok=True)
    for rank, i in enumerate(worst):
        save_comparison_png(
            {f"controlled (mse {mses[i]:.2e})": finals[i, ..., 0],
             "target": targets[i, ..., 0],
             "zero force": zeros[i, ..., 0]},
            os.path.join(outdir, f"worst_{tag}_{rank}.png"))
    return [int(i) for i in worst]


def _print_row(tag, row, zero=True):
    line = {"mse": row["final_state_mse"]}
    if zero:
        line["zero"] = row["zero_force_final_mse"]
    line["ratio"] = row["ratio_vs_zero_force"]
    print(json.dumps({tag: line}), flush=True)


def _write(workdir, results):
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)


def generalize_shapes(workdir: str, init_from: str, size: int = 64,
                      n: int = 16, num_val: int = 32, batch_size: int = 8,
                      smoke_test: bool = False, device=None) -> dict:
    """Config-3 controller on withheld shape families (eval only)."""
    if smoke_test:
        size, n, num_val, batch_size = 16, 4, 8, 4
    domain = Domain2D.create(size, size, device=resolve_device(device))
    cfg = FluidConfig(dt=1.0, buoyancy=0.0, pressure_tol=1e-4,
                      pressure_maxiter=200, warm_start_pressure=True)
    pde = IncompressibleFluidPDE(domain, cfg, control="direct",
                                 unet_levels=3 if size >= 32 else 2)
    nets = ("CFE",) + tuple(f"OP{s}" for s in op_spans(n))
    restore = {name: init_from for name in nets}
    results = {"init_from": init_from, "protocol":
               "same physics/forcing generator, init family varies; "
               "training saw 'shapes' (circles+boxes) only"}
    for family, seed in (("shapes", 999), ("crosses", 1999),
                         ("rings", 2999)):
        val = generate_forced_smoke_dataset(domain, cfg, num_val, n,
                                            seed=seed, init=family)
        app = _eval_app(pde, n, val, restore, "staggered",
                        batch_size=batch_size)
        results[family] = _row(app, val, n)
        _print_row(family, results[family])
        # Planning against actuation: the same CFE with no OP planning (the
        # final target at every step). An out-of-distribution gap in the
        # staggered rows but not here lies in the OPs' midpoints; one here
        # too lies in the CFE's actuation.
        app_chain = _eval_app(pde, n, val, {"CFE": init_from},
                              "chain_final", batch_size=batch_size)
        results[f"{family}_chain"] = _row(app_chain, val, n)
        _print_row(f"{family}_chain", results[f"{family}_chain"], zero=False)
        if family in ("shapes", "rings"):
            results[f"{family}_worst_idx"] = _render_worst(
                app, val, n, workdir, family)
    _write(workdir, results)
    return results


def ood_obstacles(h: int, w: int) -> np.ndarray:
    """An obstacle course never seen in training (`default_obstacles` has
    two staggered plates at 0.45h/0.72h): three plates, other rows, other
    spans, one centred slot."""
    course = union(
        Box(y0=h * 0.30, x0=w * 0.30, y1=h * 0.30 + 2, x1=w * 0.75),
        Box(y0=h * 0.55, x0=w * 0.05, y1=h * 0.55 + 2, x1=w * 0.40),
        Box(y0=h * 0.55, x0=w * 0.62, y1=h * 0.55 + 2, x1=w * 0.95),
    )
    return rasterize(course, h, w, device="cpu").numpy()


def generalize_smoke(workdir: str, init_from: str, size: int = 64,
                     n: int = 16, num_val: int = 32, batch_size: int = 8,
                     control_amplitude: float = 1.0,
                     width: int = 1,
                     smoke_test: bool = False, device=None) -> dict:
    """Config-4 controller on unseen obstacles, shifted inflow and longer
    horizons (eval only)."""
    device = resolve_device(device)
    if smoke_test:
        size, n, num_val, batch_size = 16, 4, 8, 4
    cfg = FluidConfig(dt=1.0, buoyancy=0.08, pressure_tol=1e-4,
                      pressure_maxiter=200, warm_start_pressure=True)

    def make_pde(domain):
        return IncompressibleFluidPDE(
            domain, cfg, control="buoyancy", with_inflow=True,
            unet_levels=3 if size >= 32 else 2,
            cfe_features=tuple(width * f for f in (48, 96, 96, 48)),
            op_base_features=16 * width)

    domain_in = Domain2D.create(
        size, size, obstacle_mask=default_obstacles(size, size), device=device)
    nets = ("CFE",) + tuple(f"OP{s}" for s in op_spans(n))
    restore = {name: init_from for name in nets}
    results = {"init_from": init_from}

    def eval_case(tag, domain, seed, inflow_kwargs=None, horizon=None,
                  scheme="staggered", amp=None):
        nh = horizon or n
        pde = make_pde(domain)
        val = generate_inflow_smoke_dataset(
            domain, cfg, num_val, nh, seed=seed,
            control_amplitude=amp if amp is not None else control_amplitude,
            inflow_kwargs=inflow_kwargs)
        rmap = (restore if nh == n and scheme == "staggered"
                else {"CFE": init_from})
        sch = scheme if nh == n else "chain_final"
        app = _eval_app(pde, nh, val, rmap, sch, batch_size=batch_size)
        results[tag] = _row(app, val, nh)
        results[tag]["scheme"] = sch
        _print_row(tag, results[tag])

    # in-distribution references (staggered, and the chain the horizon
    # rows use, so that the horizon comparison is scheme-matched)
    eval_case("in_dist", domain_in, seed=999)
    eval_case("in_dist_chain", domain_in, seed=999, scheme="chain_final",
              horizon=n)
    # (a) unseen obstacle course
    dom_ood = Domain2D.create(
        size, size, obstacle_mask=ood_obstacles(size, size), device=device)
    eval_case("obstacles_ood", dom_ood, seed=1999)
    # (b) shifted inflow: emitter band and height outside the training draw
    eval_case("inflow_shifted", domain_in, seed=2999,
              inflow_kwargs=dict(y0=10.0, x_range=(0.05, 0.30)))
    # (c) longer horizons: the CFE chained past its training n, the
    # amplitude scaled by n/nh so that the withheld drift stays CFL-safe
    if not smoke_test:
        for nh in (24, 32):
            eval_case(f"horizon_{nh}", domain_in, seed=3999 + nh,
                      horizon=nh, amp=control_amplitude * n / nh)
    _write(workdir, results)
    return results
