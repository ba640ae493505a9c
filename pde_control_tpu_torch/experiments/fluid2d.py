"""2D fluid experiments: the indirect smoke-control task (BASELINE config 4).

Counterpart of the smoke-indirect part of
`pde_control_tpu/experiments/fluid2d.py`: an inflow-driven plume through a
two-plate obstacle course, steered only by a buoyancy modulation (an
upward force ∝ smoke density), with targets generated under withheld
random forcing, so that zero control cannot reproduce them
(evaluate_control reports the zero-force baseline beside the controlled
MSE). The same seeds and disk-cache keys as the JAX package, so that a
`--datadir` tree written by either loads in the other.

Shape transition (config 3) and natural flow (config 5) are not ported
yet: they need the shape generators and data parallelism.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from pde_control_tpu_torch.control.pde_fluid import IncompressibleFluidPDE
from pde_control_tpu_torch.data.generate import generate_inflow_smoke_dataset
from pde_control_tpu_torch.data.scene import load_or_generate
from pde_control_tpu_torch.experiments.curriculum import (
    CurriculumConfig,
    finetune_e2e,
    run_curriculum,
)
from pde_control_tpu_torch.geom import Box, rasterize, union
from pde_control_tpu_torch.grids import Domain2D, resolve_device
from pde_control_tpu_torch.physics.fluid import FluidConfig


def _physics_key(cfg: FluidConfig) -> dict:
    """Physics fields baked into generated data, part of the disk-cache key
    (a dt/buoyancy/solver change must regenerate). Leaves out 'fused', a
    routing knob with the same math to tolerance."""
    d = dataclasses.asdict(cfg)
    d.pop("fused", None)
    return d


def _maybe_cached(datadir, split: str, params: dict, build):
    """Route dataset generation through the disk cache when a datadir is
    given (generate once to a scene tree, reload thereafter)."""
    if datadir is None:
        return build()
    return load_or_generate(os.path.join(datadir, split), params, build)


def default_obstacles(h: int, w: int) -> np.ndarray:
    """The smoke task's obstacle course: two staggered plates ~2 cell-rows
    thick, so the plume must route around them. Rasterization is
    boundary-inclusive (geom.rasterize): at the production sizes the
    fractional bounds fall between cell centers and cover exactly 2 rows."""
    course = union(
        Box(y0=h * 0.45, x0=w * 0.10, y1=h * 0.45 + 2, x1=w * 0.55),
        Box(y0=h * 0.72, x0=w * 0.45, y1=h * 0.72 + 2, x1=w * 0.90),
    )
    return rasterize(course, h, w, device="cpu").numpy()


def _smoke_indirect_setup(size: int, n: int, num_train: int, num_val: int,
                          control_amplitude: float,
                          datadir: str | None, width: int = 1, device=None,
                          fused: str = "auto", conv_impl: str = "xla"):
    """The indirect-smoke task's (pde, train, val), shared by the main
    curriculum and the fine-tune entry so that both train on the same task
    and datasets (same generation seeds, same disk-cache keys).

    width multiplies the net widths. `fused` and `conv_impl` route the
    training's physics and convs (the JAX package's routes by default);
    the datasets are generated on the default route whatever they say, and
    the cache key leaves them out."""
    device = resolve_device(device)
    obstacles = default_obstacles(size, size)
    domain = Domain2D.create(size, size, obstacle_mask=obstacles,
                             device=device)
    cfg = FluidConfig(dt=1.0, buoyancy=0.08, pressure_tol=1e-4,
                      pressure_maxiter=200, warm_start_pressure=True)
    base = dict(task="smoke_indirect", size=size, n=n,
                control_amplitude=control_amplitude,
                physics=_physics_key(cfg))
    train = _maybe_cached(
        datadir, "train", dict(base, num=num_train, seed=0),
        lambda: generate_inflow_smoke_dataset(
            domain, cfg, num_train, n, seed=0,
            control_amplitude=control_amplitude))
    val = _maybe_cached(
        datadir, "val", dict(base, num=num_val, seed=999),
        lambda: generate_inflow_smoke_dataset(
            domain, cfg, num_val, n, seed=999,
            control_amplitude=control_amplitude))
    pde = IncompressibleFluidPDE(
        domain, dataclasses.replace(cfg, fused=fused), control="buoyancy",
        with_inflow=True, unet_levels=3 if size >= 32 else 2,
        cfe_features=tuple(width * f for f in (48, 96, 96, 48)),
        op_base_features=16 * width, conv_impl=conv_impl)
    return pde, train, val


def run_smoke_indirect(workdir: str, size: int = 64, n: int = 16,
                       iterations: int = 500, num_train: int = 256,
                       num_val: int = 32, batch_size: int = 8,
                       control_amplitude: float = 1.0,
                       e2e_iterations: int | None = None,
                       mesh=None, datadir: str | None = None,
                       seed: int = 0, resume: bool = False,
                       width: int = 1, lr_scale: float = 1.0,
                       device=None) -> dict:
    """Config 4: indirect smoke control — inflow-driven plume through an
    obstacle course, buoyancy-only forcing, targets from withheld control.

    `control_amplitude` scales the withheld buoyancy-modulation field (how
    far targets deviate from natural evolution). `width` multiplies all
    net widths; `lr_scale` every stage's LR."""
    pde, train, val = _smoke_indirect_setup(
        size, n, num_train, num_val, control_amplitude, datadir, width=width,
        device=device)
    # grad_clip and e2e lr 1e-4: the wide CFE diverges in e2e at 3e-4
    # unclipped.
    ccfg = CurriculumConfig(n=n, batch_size=batch_size,
                            cfe_iterations=iterations,
                            op_iterations=iterations,
                            e2e_iterations=e2e_iterations or iterations,
                            cfe_lr=1e-3 * lr_scale, op_lr=1e-3 * lr_scale,
                            e2e_lr=1e-4 * lr_scale, grad_clip=1.0,
                            force_reg=3e-5, seed=seed)
    return run_curriculum(pde, ccfg, train, val, workdir, mesh=mesh,
                          resume=resume)


def run_smoke_indirect_ft(workdir: str, init_from: str,
                          force_reg: float = 1.5e-5,
                          size: int = 64, n: int = 16,
                          num_train: int = 256, num_val: int = 32,
                          batch_size: int = 8,
                          control_amplitude: float = 1.0,
                          e2e_iterations: int | None = None,
                          mesh=None, datadir: str | None = None,
                          seed: int = 0, resume: bool = False,
                          device=None) -> dict:
    """Force-reg annealing fine-tune of a converged smoke-indirect run
    (`init_from`: its ckpt_final); the task and datasets are
    run_smoke_indirect's."""
    pde, train, val = _smoke_indirect_setup(
        size, n, num_train, num_val, control_amplitude, datadir,
        device=device)
    ccfg = CurriculumConfig(n=n, batch_size=batch_size,
                            e2e_iterations=e2e_iterations or 600,
                            e2e_lr=5e-5, grad_clip=1.0,
                            force_reg=force_reg, seed=seed)
    return finetune_e2e(pde, ccfg, train, val, workdir, init_from,
                        mesh=mesh, resume=resume)
