"""2D fluid experiments: BASELINE configs 3-5.

Counterpart of `pde_control_tpu/experiments/fluid2d.py`. Every task's
targets are generated under withheld random forcing, so that zero control
cannot reproduce them (evaluate_control reports the zero-force baseline
beside the controlled MSE):
  * shape transition (config 3): 64², direct two-channel force; soft
    rasterized circles and boxes pushed by withheld random forces;
  * indirect smoke control (config 4): an inflow-driven plume through a
    two-plate obstacle course, steered only by a buoyancy modulation (an
    upward force ∝ smoke density);
  * natural-flow reconstruction (config 5): 128-step rollouts of buoyant
    blobs under withheld forcing, with staged horizon growth
    (32 → 64 → 128) and dense observation frames (32/64/96/128).
The same seeds, force amplitudes and disk-cache keys as the JAX package,
so that a `--datadir` tree written by either loads in the other. Each
entry takes `mesh` (data parallelism, `parallel/mesh.py`): every rank
generates the same datasets from the same seeds, or, with a datadir, rank
0 writes the cache and the other ranks read it (`_setup_on_ranks`).

Each `_*_setup` takes `device`, `fused` and `conv_impl`: the last two
route the training's physics and convs (the JAX package's routes by
default); the datasets are generated on the default route whatever they
say, and the cache key leaves them out. Configs 3 and 5 run in a closed box
without obstacles, where the default route is the exact spectral pressure
solve, as in the JAX package, and the fused kernels refuse to stand in for
it. Their setups take `pressure_backend` too: 'cuda' puts the pressure
solve of the data and of the unfused training on the PCG kernel (K1) and
lets `fused='cuda'` run (K2/K3), both tol-bounded PCG in place of the exact
solve. It is baked into the data, so it is part of the cache key, as every
physics field is.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from pde_control_tpu_torch.control.pde_fluid import IncompressibleFluidPDE
from pde_control_tpu_torch.data.generate import (
    generate_forced_smoke_dataset,
    generate_inflow_smoke_dataset,
)
from pde_control_tpu_torch.data.scene import concat_datasets, load_or_generate
from pde_control_tpu_torch.experiments.curriculum import (
    CurriculumConfig,
    finetune_e2e,
    run_curriculum,
)
from pde_control_tpu_torch.geom import Box, rasterize, union
from pde_control_tpu_torch.grids import Domain2D, resolve_device
from pde_control_tpu_torch.parallel.mesh import is_writer, rank0_first
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


def _setup_on_ranks(setup, mesh, datadir, *args, **kw):
    """`setup(*args, datadir, **kw)` on every rank; with a datadir, rank 0
    first (it writes the cache that the other ranks then read)."""
    with rank0_first(mesh if datadir else None):
        return setup(*args, datadir, **kw)


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


def _training_pde(domain: Domain2D, cfg: FluidConfig, fused: str,
                  conv_impl: str, **kw) -> IncompressibleFluidPDE:
    """The task's PDE with the training's routes (the data keeps `cfg`'s)."""
    return IncompressibleFluidPDE(
        domain, dataclasses.replace(cfg, fused=fused), conv_impl=conv_impl,
        **kw)


def _shape_transition_cfg(pressure_backend: str = "auto") -> FluidConfig:
    return FluidConfig(dt=1.0, buoyancy=0.0, pressure_tol=1e-4,
                       pressure_maxiter=200, warm_start_pressure=True,
                       pressure_backend=pressure_backend)


def _shape_transition_setup(size: int, n: int, num_train: int, num_val: int,
                            datadir: str | None, device=None,
                            fused: str = "auto", conv_impl: str = "xla",
                            pressure_backend: str = "auto"):
    """Config 3's (pde, train, val), shared by the main curriculum and the
    fine-tune entry (same generation seeds, same disk-cache keys)."""
    domain = Domain2D.create(size, size, device=device)
    cfg = _shape_transition_cfg(pressure_backend)
    # force_amplitude pins the generator's default into the cache key: a
    # retune must regenerate.
    base = dict(task="shape_transition", size=size, n=n, init="shapes",
                physics=_physics_key(cfg), force_amplitude=0.1)
    train = _maybe_cached(
        datadir, "train", dict(base, num=num_train, seed=0),
        lambda: generate_forced_smoke_dataset(domain, cfg, num_train, n,
                                              seed=0, init="shapes"))
    val = _maybe_cached(
        datadir, "val", dict(base, num=num_val, seed=999),
        lambda: generate_forced_smoke_dataset(domain, cfg, num_val, n,
                                              seed=999, init="shapes"))
    pde = _training_pde(domain, cfg, fused, conv_impl, control="direct",
                        unet_levels=3 if size >= 32 else 2)
    return pde, train, val


def run_shape_transition(workdir: str, size: int = 64, n: int = 16,
                         iterations: int = 500, num_train: int = 256,
                         num_val: int = 32, batch_size: int = 8,
                         mesh=None, datadir: str | None = None,
                         seed: int = 0, resume: bool = False,
                         device=None) -> dict:
    """Config 3: 64² shape transition with direct forcing — soft shapes
    pushed by withheld random forces."""
    pde, train, val = _setup_on_ranks(_shape_transition_setup, mesh, datadir,
                                      size, n, num_train, num_val,
                                      device=device)
    # force_reg keeps the regularizer well under the observation MSE at
    # convergence (at 1e-4 it was still 5x the observation loss).
    ccfg = CurriculumConfig(n=n, batch_size=batch_size,
                            cfe_iterations=iterations,
                            op_iterations=iterations,
                            e2e_iterations=iterations,
                            grad_clip=1.0, force_reg=1e-5, seed=seed)
    return run_curriculum(pde, ccfg, train, val, workdir, mesh=mesh,
                          resume=resume)


def run_shape_transition_ft(workdir: str, init_from: str,
                            force_reg: float = 5e-6,
                            size: int = 64, n: int = 16,
                            num_train: int = 256, num_val: int = 32,
                            batch_size: int = 8,
                            e2e_iterations: int | None = None,
                            mesh=None, datadir: str | None = None,
                            seed: int = 0, resume: bool = False,
                            device=None) -> dict:
    """Force-reg annealing fine-tune of a converged config-3 run
    (`init_from`: its ckpt_final); the task and datasets are
    run_shape_transition's."""
    pde, train, val = _setup_on_ranks(_shape_transition_setup, mesh, datadir,
                                      size, n, num_train, num_val,
                                      device=device)
    ccfg = CurriculumConfig(n=n, batch_size=batch_size,
                            e2e_iterations=e2e_iterations or 600,
                            e2e_lr=5e-5, grad_clip=1.0,
                            force_reg=force_reg, seed=seed)
    return finetune_e2e(pde, ccfg, train, val, workdir, init_from,
                        mesh=mesh, resume=resume)


def run_shape_transition_rings_ft(workdir: str, init_from: str,
                                  ring_fraction: float = 0.25,
                                  size: int = 64, n: int = 16,
                                  num_train: int = 256, num_val: int = 32,
                                  batch_size: int = 8,
                                  e2e_iterations: int | None = None,
                                  mesh=None, seed: int = 0,
                                  resume: bool = False,
                                  device=None) -> dict:
    """Fine-tune a converged config-3 controller on a mixed dataset: the
    circles and boxes plus a `ring_fraction` share of rings (hollow
    topology, withheld from the base run), at the training force_reg: a
    data treatment for the rings' out-of-distribution gap, not a reg
    anneal. Generated afresh (no disk cache), as the JAX package does."""
    domain = Domain2D.create(size, size, device=device)
    cfg = _shape_transition_cfg()
    n_rings = max(int(num_train * ring_fraction), 1)
    # The shapes share the base run's generation seed (same distribution);
    # the rings' seed is disjoint from the generalization eval's (2999).
    train = concat_datasets(
        generate_forced_smoke_dataset(domain, cfg, num_train - n_rings, n,
                                      seed=0, init="shapes"),
        generate_forced_smoke_dataset(domain, cfg, n_rings, n,
                                      seed=7777, init="rings"))
    val = generate_forced_smoke_dataset(domain, cfg, num_val, n,
                                        seed=999, init="shapes")
    pde = IncompressibleFluidPDE(domain, cfg, control="direct",
                                 unet_levels=3 if size >= 32 else 2)
    ccfg = CurriculumConfig(n=n, batch_size=batch_size,
                            e2e_iterations=e2e_iterations or 600,
                            e2e_lr=5e-5, grad_clip=1.0,
                            force_reg=1e-5, seed=seed)
    results = finetune_e2e(pde, ccfg, train, val, workdir, init_from,
                           mesh=mesh, resume=resume)
    results["ring_fraction"] = ring_fraction
    if is_writer(mesh):
        with open(os.path.join(workdir, "results.json"), "w") as f:
            json.dump(results, f, indent=2, default=float)
    return results


def _smoke_indirect_setup(size: int, n: int, num_train: int, num_val: int,
                          control_amplitude: float,
                          datadir: str | None, width: int = 1, device=None,
                          fused: str = "auto", conv_impl: str = "xla"):
    """The indirect-smoke task's (pde, train, val), shared by the main
    curriculum and the fine-tune entry so that both train on the same task
    and datasets (same generation seeds, same disk-cache keys). width
    multiplies the net widths."""
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
    pde = _training_pde(
        domain, cfg, fused, conv_impl, control="buoyancy", with_inflow=True,
        unet_levels=3 if size >= 32 else 2,
        cfe_features=tuple(width * f for f in (48, 96, 96, 48)),
        op_base_features=16 * width)
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
    pde, train, val = _setup_on_ranks(
        _smoke_indirect_setup, mesh, datadir, size, n, num_train, num_val,
        control_amplitude, width=width, device=device)
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
    pde, train, val = _setup_on_ranks(
        _smoke_indirect_setup, mesh, datadir, size, n, num_train, num_val,
        control_amplitude, device=device)
    ccfg = CurriculumConfig(n=n, batch_size=batch_size,
                            e2e_iterations=e2e_iterations or 600,
                            e2e_lr=5e-5, grad_clip=1.0,
                            force_reg=force_reg, seed=seed)
    return finetune_e2e(pde, ccfg, train, val, workdir, init_from,
                        mesh=mesh, resume=resume)


def _natural_flow_setup(size: int, n: int, num_train: int, num_val: int,
                        datadir: str | None, device=None,
                        fused: str = "auto", conv_impl: str = "xla",
                        pressure_backend: str = "auto"):
    """Config 5's (pde, train, val), shared by the main curriculum and the
    fine-tune entry (same generation seeds, same disk-cache keys)."""
    domain = Domain2D.create(size, size, device=device)
    cfg = FluidConfig(dt=0.5, buoyancy=0.05, pressure_tol=1e-4,
                      pressure_maxiter=200, warm_start_pressure=True,
                      pressure_backend=pressure_backend)
    base = dict(task="natural_flow", size=size, n=n, init="blobs",
                physics=_physics_key(cfg), force_amplitude=0.05, dt=0.5)
    train = _maybe_cached(
        datadir, "train", dict(base, num=num_train, seed=0),
        lambda: generate_forced_smoke_dataset(
            domain, cfg, num_train, n, seed=0, init="blobs",
            force_amplitude=0.05))
    val = _maybe_cached(
        datadir, "val", dict(base, num=num_val, seed=999),
        lambda: generate_forced_smoke_dataset(
            domain, cfg, num_val, n, seed=999, init="blobs",
            force_amplitude=0.05))
    pde = _training_pde(domain, cfg, fused, conv_impl, control="direct",
                        unet_levels=3)
    return pde, train, val


def _obs_frames(n: int) -> tuple:
    """Config 5's observation frames: 32/64/96 below n, and n."""
    return tuple(f for f in (32, 64, 96) if f < n) + (n,)


def run_natural_flow_128_ft(workdir: str, init_from: str,
                            force_reg: float = 5e-6,
                            size: int = 64, n: int = 128,
                            num_train: int = 128, num_val: int = 16,
                            batch_size: int = 8,
                            e2e_iterations: int | None = None,
                            mesh=None, datadir: str | None = None,
                            seed: int = 0, resume: bool = False,
                            device=None) -> dict:
    """Force-reg annealing fine-tune of a converged config-5 run. Keeps
    the base run's dense observation frames (needed for stable gradients
    over the long horizon), the clip and a low LR; only the reg anneals,
    over a fresh cosine cycle."""
    pde, train, val = _setup_on_ranks(_natural_flow_setup, mesh, datadir,
                                      size, n, num_train, num_val,
                                      device=device)
    ccfg = CurriculumConfig(n=n, batch_size=batch_size,
                            e2e_iterations=e2e_iterations or 2000,
                            e2e_lr=5e-5, grad_clip=1.0,
                            e2e_obs_frames=_obs_frames(n),
                            force_reg=force_reg, seed=seed)
    return finetune_e2e(pde, ccfg, train, val, workdir, init_from,
                        mesh=mesh, resume=resume)


def run_natural_flow_128(workdir: str, size: int = 64, n: int = 128,
                         iterations: int = 300, num_train: int = 128,
                         num_val: int = 16, batch_size: int = 8,
                         e2e_iterations: int | None = None,
                         mesh=None, datadir: str | None = None,
                         seed: int = 0, resume: bool = False,
                         sequence: str = "staggered", device=None) -> dict:
    """Config 5: batched 128-step forced-flow reconstruction — buoyant
    blobs under withheld random forcing (zero force cannot match).

    `sequence` selects the e2e scheme: 'staggered' (the protocol's) or
    'refined' (one eager recursion in the port at every n)."""
    pde, train, val = _setup_on_ranks(_natural_flow_setup, mesh, datadir,
                                      size, n, num_train, num_val,
                                      device=device)
    # At n=128 the e2e stage diverged at lr 3e-4; staged horizon growth
    # and a lower LR keep the long-rollout gradients stable.
    ccfg = CurriculumConfig(n=n, batch_size=batch_size,
                            cfe_iterations=iterations,
                            op_iterations=iterations,
                            e2e_iterations=e2e_iterations or iterations,
                            e2e_sequence=sequence,
                            e2e_lr=1e-4,
                            e2e_stage_ns=tuple(
                                s for s in (32, 64) if s < n) + (n,),
                            e2e_obs_frames=_obs_frames(n),
                            force_reg=1e-5, grad_clip=1.0, seed=seed)
    return run_curriculum(pde, ccfg, train, val, workdir, mesh=mesh,
                          resume=resume)
