"""2D incompressible Navier-Stokes step (smoke / shape-transition physics).

Counterpart of `pde_control_tpu/physics/fluid.py`. Order of operations:
advect(density, velocity) → inflow → advect(velocity) → diffuse → forces,
buoyancy → pressure projection. With `FluidConfig.fused='cuda'` the whole
step runs as one kernel per direction (`ops/cuda_fluid.py`).
"""

from __future__ import annotations

import dataclasses

import torch

from pde_control_tpu_torch.grids import (
    Domain2D,
    Staggered2D,
    centered_to_y_faces,
    resolve_device,
)
from pde_control_tpu_torch.ops.cuda_fluid import fused_fluid_step, fused_step_fits
from pde_control_tpu_torch.ops.stencils import laplace
from pde_control_tpu_torch.physics.advect import advect_centered, advect_staggered
from pde_control_tpu_torch.physics.poisson import solve_pressure


@dataclasses.dataclass
class FluidState:
    """velocity: MAC grid; density: (B, H, W) passive marker (smoke);
    inflow: optional (B, H, W) per-sample smoke source rate (dt·inflow is
    added to density each step); pressure: optional (B, H, W) previous
    step's pressure, which warm-starts the next projection's CG (detached
    at use)."""

    velocity: Staggered2D
    density: torch.Tensor
    inflow: torch.Tensor | None = None
    pressure: torch.Tensor | None = None

    @classmethod
    def zeros(cls, batch: int, h: int, w: int, dtype=torch.float32,
              with_inflow: bool = False, device=None) -> "FluidState":
        """A state at rest on `device` (the GPU when None); with
        `with_inflow`, a zero inflow field too."""
        device = resolve_device(device)
        return cls(
            velocity=Staggered2D.zeros(batch, h, w, dtype, device),
            density=torch.zeros((batch, h, w), dtype=dtype, device=device),
            inflow=(torch.zeros((batch, h, w), dtype=dtype, device=device)
                    if with_inflow else None),
        )


@dataclasses.dataclass(frozen=True)
class FluidConfig:
    """Solver parameters for the NS step."""

    dt: float = 1.0
    viscosity: float = 0.0
    buoyancy: float = 0.1          # upward force per unit density (y+ is up)
    advection_mode: str = "shift"  # the only mode ported
    max_shift: int = 2             # CFL bound for shift advection
    pressure_tol: float = 1e-5
    pressure_maxiter: int = 500
    # 'auto' | 'cuda' | 'pcg' | 'jax' | 'spectral' — see poisson.solve_pressure.
    pressure_backend: str = "auto"
    # Seed rollouts with a zero pressure field (PDE.initial_state) so each
    # step's CG warm-starts from the previous step's solution.
    warm_start_pressure: bool = False
    # Whole-step fusion (ops/cuda_fluid.py): 'cuda' runs the step as one
    # kernel per direction where supported (2D, closed, shift advection, no
    # viscosity, static buoyancy, fits shared memory) and raises elsewhere;
    # on CPU tensors it runs the kernels' plain versions. 'auto' and 'off'
    # take the unfused step, as in the JAX package.
    fused: str = "auto"

    def __post_init__(self):
        if self.fused == "pallas":
            raise ValueError("fused='pallas' is the JAX package's name; the "
                             "port's whole-step kernel is fused='cuda'")
        if self.fused not in ("auto", "off", "cuda"):
            raise ValueError(f"unknown fused mode {self.fused!r}")


def _fused_applicable(state: FluidState, domain: Domain2D, cfg: FluidConfig,
                      buoyancy_factor) -> bool:
    """Whether the step takes the fused kernels (see FluidConfig.fused).
    'cuda' on a configuration the kernels do not implement raises."""
    if cfg.fused != "cuda":
        return False
    supported = (
        buoyancy_factor is None
        and cfg.advection_mode == "shift"
        and not cfg.viscosity
        and domain.closed
        and state.density.dim() == 3
        and fused_step_fits(*domain.grid_shape)
    )
    if not supported:
        raise ValueError(
            "FluidConfig.fused='cuda' but this configuration is not supported "
            "by the fused kernel (needs 2D closed domain, shift advection, "
            "viscosity=0, static buoyancy, a grid fused_step_fits takes: "
            "sides up to 84)")
    if not domain.has_obstacles and cfg.pressure_backend in ("auto", "spectral"):
        # The unfused step would take the exact spectral solve here; the
        # fused kernel always runs tol-bounded PCG.
        raise ValueError(
            "FluidConfig.fused='cuda' conflicts with the exact spectral "
            "pressure solve this domain would use (closed, no obstacles). "
            "Set pressure_backend='pcg' explicitly to accept tol-bounded "
            "pressure, or fused='off'/'auto'.")
    return True


def divergence_free(
    v: Staggered2D, domain: Domain2D, cfg: FluidConfig,
    x0: torch.Tensor | None = None,
) -> tuple[Staggered2D, torch.Tensor]:
    """Project velocity onto its divergence-free part (Chorin projection).

    Returns (v', p) with div v' ≈ 0 on fluid cells and v'·n = 0 on blocked
    faces. `x0` optionally warm-starts the iterative pressure solve.
    """
    v = domain.mask_velocity(v)
    div = v.divergence(domain.dx)
    p = solve_pressure(div, domain, tol=cfg.pressure_tol,
                       maxiter=cfg.pressure_maxiter,
                       backend=cfg.pressure_backend, x0=x0)
    return v - domain.pressure_gradient(p), p


def fluid_step(
    state: FluidState,
    domain: Domain2D,
    cfg: FluidConfig,
    force: Staggered2D | None = None,
    buoyancy_factor: torch.Tensor | float | None = None,
    inflow: torch.Tensor | None = None,
) -> FluidState:
    """One differentiable incompressible-flow step.

    Args:
      state: current (velocity, density).
      domain: geometry (walls, obstacles).
      cfg: solver parameters.
      force: optional staggered control force, applied as +dt·F.
      buoyancy_factor: overrides cfg.buoyancy when given; may be a
        per-batch tensor (B, 1, 1).
      inflow: optional (B, H, W) or (H, W) smoke source rate; defaults to
        state.inflow.
    Returns: next FluidState (projected velocity, advected density).
    """
    dt, dx = cfg.dt, domain.dx
    adv = dict(dx=dx, mode=cfg.advection_mode, max_shift=cfg.max_shift)
    if inflow is None:
        inflow = state.inflow

    if _fused_applicable(state, domain, cfg, buoyancy_factor):
        if inflow is not None and inflow.dim() == 2:
            inflow = inflow.expand(state.density.shape)
        vy, vx, rho, p = fused_fluid_step(
            state.velocity.vy, state.velocity.vx, state.density,
            domain.acc_y, domain.acc_x, domain.fluid_mask,
            fy=None if force is None else force.vy,
            fx=None if force is None else force.vx,
            inflow=inflow, x0=state.pressure, dt=dt, dx=dx,
            max_shift=cfg.max_shift, buoyancy=cfg.buoyancy,
            closed=domain.closed, tol=cfg.pressure_tol,
            maxiter=cfg.pressure_maxiter)
        return FluidState(velocity=Staggered2D(vy=vy, vx=vx), density=rho,
                          inflow=state.inflow,
                          pressure=p if state.pressure is not None else None)

    density = advect_centered(state.density, state.velocity, dt, **adv)
    if inflow is not None:
        density = density + dt * inflow
    v = advect_staggered(state.velocity, dt, **adv)

    if cfg.viscosity:
        v = Staggered2D(
            vy=v.vy + dt * cfg.viscosity * laplace(v.vy, dx, "neumann"),
            vx=v.vx + dt * cfg.viscosity * laplace(v.vx, dx, "neumann"),
        )

    if force is not None:
        v = v + dt * force

    buoy = cfg.buoyancy if buoyancy_factor is None else buoyancy_factor
    if buoyancy_factor is not None or cfg.buoyancy:
        v = Staggered2D(vy=v.vy + dt * buoy * centered_to_y_faces(density),
                        vx=v.vx)

    v, p = divergence_free(v, domain, cfg, x0=state.pressure)
    return FluidState(velocity=v, density=density, inflow=state.inflow,
                      pressure=p if state.pressure is not None else None)
