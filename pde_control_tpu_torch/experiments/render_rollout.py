"""Render controlled rollouts from a trained experiment checkpoint.

Counterpart of `pde_control_tpu/experiments/render_rollout.py`. For one
validation sample it writes four trajectory strips: the controlled
density, the ground truth (made under the withheld forcing), the
zero-force rollout, and the per-step force magnitude (magma); and prints
the controlled and zero-force final MSEs and their ratio.

Usage:
    python -m pde_control_tpu_torch.experiments.render_rollout smoke_indirect \
        [--workdir runs/smoke_indirect] [--sample 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pde_control_tpu_torch.experiments.curriculum import op_spans

SIZE, N = 64, 16  # the experiments' grid side and horizon


def _build(name: str, workdir: str, device=None):
    """Rebuild the experiment's PDE, validation data and trained app
    (`workdir/ckpt_final`, either package's)."""
    from pde_control_tpu_torch.control.pde_fluid import IncompressibleFluidPDE
    from pde_control_tpu_torch.control.training import ControlTraining
    from pde_control_tpu_torch.data.generate import (
        generate_forced_smoke_dataset,
        generate_inflow_smoke_dataset,
    )
    from pde_control_tpu_torch.experiments.fluid2d import default_obstacles
    from pde_control_tpu_torch.grids import Domain2D, resolve_device
    from pde_control_tpu_torch.physics.fluid import FluidConfig

    device = resolve_device(device)
    size, n = SIZE, N
    if name == "smoke_indirect":
        obstacles = default_obstacles(size, size)
        domain = Domain2D.create(size, size, obstacle_mask=obstacles,
                                 device=device)
        cfg = FluidConfig(dt=1.0, buoyancy=0.08, pressure_tol=1e-4,
                          pressure_maxiter=200, warm_start_pressure=True)
        # Must mirror experiments/fluid2d.py :: _smoke_indirect_setup: the
        # checkpoint's CFE is the wide one, and the eval data's withheld
        # control amplitude defines the task.
        val = generate_inflow_smoke_dataset(domain, cfg, 8, n, seed=999,
                                            control_amplitude=1.0)
        pde = IncompressibleFluidPDE(domain, cfg, control="buoyancy",
                                     with_inflow=True, unet_levels=3,
                                     cfe_features=(48, 96, 96, 48))
        obstacle_mask = obstacles
    elif name == "shape_transition":
        domain = Domain2D.create(size, size, device=device)
        cfg = FluidConfig(dt=1.0, buoyancy=0.0, pressure_tol=1e-4,
                          pressure_maxiter=200, warm_start_pressure=True)
        val = generate_forced_smoke_dataset(domain, cfg, 8, n, seed=999,
                                            init="shapes")
        pde = IncompressibleFluidPDE(domain, cfg, control="direct",
                                     unet_levels=3)
        obstacle_mask = None
    else:
        raise ValueError(f"no render recipe for {name!r}")

    app = ControlTraining(
        n, pde, batch_size=8,
        trainable_networks=("CFE",) + tuple(f"OP{k}" for k in op_spans(n)),
        sequence_class="staggered", obs_loss_frames=(n,),
        restore=os.path.join(workdir, "ckpt_final"),
    ).prepare()
    return app, val, n, obstacle_mask


def render(name: str, workdir: str, sample: int = 0,
           outdir: str | None = None, device=None) -> dict:
    from pde_control_tpu_torch.experiments.curriculum import zero_force_baseline
    from pde_control_tpu_torch.utils.viz import save_trajectory_strip

    app, val, n, obstacles = _build(name, workdir, device)
    outdir = outdir or os.path.join(workdir, "renders")
    os.makedirs(outdir, exist_ok=True)
    batch = val.sample(np.random.default_rng(7), 8)

    obs_traj, _costs, _final, _states, forces = app.infer_all_frames(
        batch, keep_states=True, keep_forces=True)
    controlled = obs_traj.cpu().numpy()[:, sample, :, :, 0]   # (n, H, W)
    gt = np.asarray(batch["obs"])[sample, 1:, :, :, 0]

    # The zero-force trajectory by the helper the eval metrics use, so that
    # the renders cannot drift from evaluate_control's uncontrolled rollout.
    natural = zero_force_baseline(app, batch, all_frames=True)[
        :, sample, :, :, 0]

    # Force magnitude per step (centred magnitude of the staggered force).
    fy = forces.vy[:, sample].cpu().numpy()
    fx = forces.vx[:, sample].cpu().numpy()
    fmag = np.sqrt(0.5 * (fy[:, 1:, :] ** 2 + fy[:, :-1, :] ** 2)
                   + 0.5 * (fx[:, :, 1:] ** 2 + fx[:, :, :-1] ** 2))

    def overlay(frames):
        if obstacles is None:
            return frames
        return frames + 1.2 * frames.max() * obstacles[None]

    every = max(1, n // 8)
    save_trajectory_strip(overlay(controlled), f"{outdir}/controlled.png",
                          every=every)
    save_trajectory_strip(overlay(gt), f"{outdir}/ground_truth.png",
                          every=every)
    save_trajectory_strip(overlay(natural), f"{outdir}/zero_force.png",
                          every=every)
    save_trajectory_strip(fmag, f"{outdir}/force_magnitude.png", every=every,
                          cmap="magma")

    ctrl_mse = float(np.mean((controlled[-1] - gt[-1]) ** 2))
    zero_mse = float(np.mean((natural[-1] - gt[-1]) ** 2))
    print(f"sample {sample}: controlled final MSE {ctrl_mse:.3e}, "
          f"zero-force {zero_mse:.3e}, ratio "
          f"{zero_mse / max(ctrl_mse, 1e-30):.1f}x")
    print(f"renders in {outdir}/")
    return {"controlled_mse": ctrl_mse, "zero_force_mse": zero_mse}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("name", choices=["smoke_indirect", "shape_transition"])
    p.add_argument("--workdir", default=None)
    p.add_argument("--sample", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    render(args.name, args.workdir or f"runs/{args.name}", args.sample,
           device=args.device)


if __name__ == "__main__":
    main()
