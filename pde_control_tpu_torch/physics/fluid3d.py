"""3D incompressible Navier-Stokes step (smoke): semi-Lagrangian advection,
buoyancy, masked pressure projection.

Counterpart of `pde_control_tpu/physics/fluid3d.py`. The order of
operations is the 2D step's: advect density (then inflow) and velocity →
diffuse → effects (force, buoyancy on vz; z is up) → project. The
pressure solve is `physics/poisson.py :: solve_pressure`, which takes
volumes: the exact spectral solve in a box without obstacles, the
spectrally preconditioned CG with them (which a CUDA graph can capture:
it then runs all `maxiter` trips). No kernel runs here: the fused step
and the pressure kernel are 2D only, as the JAX package's Pallas kernels
are.
"""

from __future__ import annotations

import dataclasses

import torch

from pde_control_tpu_torch.grids import resolve_device
from pde_control_tpu_torch.grids3d import (
    Domain3D,
    Staggered3D,
    centered_to_x_faces_3d,
    centered_to_y_faces_3d,
    centered_to_z_faces,
)
from pde_control_tpu_torch.ops.interp3d import (
    shift_trilinear_sample_3d,
    trilinear_sample_3d,
)
from pde_control_tpu_torch.physics.poisson import solve_pressure


@dataclasses.dataclass
class FluidState3D:
    """velocity: 3D MAC grid; density: (B, D, H, W) passive smoke marker;
    inflow: optional source rate (dt·inflow added per step); pressure:
    optional previous step's pressure, which warm-starts the next
    projection's CG (detached at use) — the 2D FluidState's contract."""

    velocity: Staggered3D
    density: torch.Tensor
    inflow: torch.Tensor | None = None
    pressure: torch.Tensor | None = None

    @classmethod
    def zeros(cls, batch: int, d: int, h: int, w: int, dtype=torch.float32,
              with_inflow: bool = False, device=None) -> "FluidState3D":
        """A state at rest on `device` (the GPU when None)."""
        device = resolve_device(device)
        shape = (batch, d, h, w)
        return cls(
            velocity=Staggered3D.zeros(batch, d, h, w, dtype, device),
            density=torch.zeros(shape, dtype=dtype, device=device),
            inflow=(torch.zeros(shape, dtype=dtype, device=device)
                    if with_inflow else None),
        )


@dataclasses.dataclass(frozen=True)
class Fluid3DConfig:
    """Solver parameters for the 3D NS step."""

    dt: float = 1.0
    viscosity: float = 0.0
    buoyancy: float = 0.1          # upward force per unit density (z+ is up)
    advection_mode: str = "shift"  # 'shift' | 'gather'
    max_shift: int = 1             # CFL bound; window is (2K+2)³ terms in 3D
    pressure_tol: float = 1e-5
    pressure_maxiter: int = 500
    # 'auto' | 'jax' | 'spectral' | 'pcg' — see poisson.solve_pressure;
    # 'cuda' raises on a volume.
    pressure_backend: str = "auto"
    warm_start_pressure: bool = False


def _resample_displaced_3d(field, dz, dy, dx_, mode, max_shift, boundary):
    if mode == "shift":
        return shift_trilinear_sample_3d(field, dz, dy, dx_, max_shift,
                                         boundary)
    if mode == "gather":
        _, d, h, w = field.shape
        kw = dict(dtype=field.dtype, device=field.device)
        iz = torch.arange(d, **kw)[None, :, None, None]
        iy = torch.arange(h, **kw)[None, None, :, None]
        ix = torch.arange(w, **kw)[None, None, None, :]
        return trilinear_sample_3d(field, iz + dz, iy + dy, ix + dx_, boundary)
    raise ValueError(f"unknown advection mode {mode!r}")


def advect_centered_3d(c: torch.Tensor, v: Staggered3D, dt: float,
                       dx: float = 1.0, mode: str = "shift",
                       max_shift: int = 1, boundary: str = "clamp"
                       ) -> torch.Tensor:
    """Advect a centered field (B, D, H, W) through velocity v for time dt."""
    vz_c, vy_c, vx_c = v.at_centers()
    return _resample_displaced_3d(c, -dt * vz_c / dx, -dt * vy_c / dx,
                                  -dt * vx_c / dx, mode, max_shift, boundary)


def advect_staggered_3d(v: Staggered3D, dt: float, dx: float = 1.0,
                        mode: str = "shift", max_shift: int = 1,
                        boundary: str = "clamp") -> Staggered3D:
    """Self-advect a 3D MAC velocity: each component at its own faces, the
    transverse components averaged to the centers, then resampled to the
    component's faces (the 2D advect_staggered's scheme)."""
    vz_c, vy_c, vx_c = v.at_centers()
    s = -dt / dx
    adv = dict(mode=mode, max_shift=max_shift, boundary=boundary)
    vz_new = _resample_displaced_3d(
        v.vz, s * v.vz, s * centered_to_z_faces(vy_c),
        s * centered_to_z_faces(vx_c), **adv)
    vy_new = _resample_displaced_3d(
        v.vy, s * centered_to_y_faces_3d(vz_c), s * v.vy,
        s * centered_to_y_faces_3d(vx_c), **adv)
    vx_new = _resample_displaced_3d(
        v.vx, s * centered_to_x_faces_3d(vz_c), s * centered_to_x_faces_3d(vy_c),
        s * v.vx, **adv)
    return Staggered3D(vz=vz_new, vy=vy_new, vx=vx_new)


def laplace_3d(f: torch.Tensor, dx: float = 1.0) -> torch.Tensor:
    """7-point Laplacian with Neumann (edge-replicate) boundaries."""
    out = torch.zeros_like(f)
    for axis in (f.dim() - 3, f.dim() - 2, f.dim() - 1):
        n = f.shape[axis]
        fp = torch.cat([f.narrow(axis, 0, 1), f, f.narrow(axis, n - 1, 1)],
                       dim=axis)
        out = (out + fp.narrow(axis, 0, n) - 2.0 * fp.narrow(axis, 1, n)
               + fp.narrow(axis, 2, n))
    return out / (dx * dx)


def divergence_free_3d(v: Staggered3D, domain: Domain3D, cfg: Fluid3DConfig,
                       x0: torch.Tensor | None = None
                       ) -> tuple[Staggered3D, torch.Tensor]:
    """Project velocity onto its divergence-free part (Chorin projection),
    with the 2D step's masked operator and solve; `x0` optionally
    warm-starts an iterative solve."""
    v = domain.mask_velocity(v)
    div = v.divergence(domain.dx)
    p = solve_pressure(div, domain, tol=cfg.pressure_tol,
                       maxiter=cfg.pressure_maxiter,
                       backend=cfg.pressure_backend, x0=x0)
    return v - domain.pressure_gradient(p), p


def fluid3d_step(
    state: FluidState3D,
    domain: Domain3D,
    cfg: Fluid3DConfig,
    force: Staggered3D | None = None,
    buoyancy_factor: torch.Tensor | float | None = None,
    inflow: torch.Tensor | None = None,
) -> FluidState3D:
    """One differentiable 3D incompressible-flow step.

    `buoyancy_factor` overrides cfg.buoyancy: a (B, 1, 1, 1) tensor or a
    full (B, D, H, W) centered field, which weights the density at the
    centers before the resample to z-faces. `inflow` defaults to
    state.inflow.
    """
    dt, dx = cfg.dt, domain.dx
    adv = dict(dx=dx, mode=cfg.advection_mode, max_shift=cfg.max_shift)
    if inflow is None:
        inflow = state.inflow

    density = advect_centered_3d(state.density, state.velocity, dt, **adv)
    if inflow is not None:
        density = density + dt * inflow
    v = advect_staggered_3d(state.velocity, dt, **adv)

    if cfg.viscosity:
        v = Staggered3D(
            vz=v.vz + dt * cfg.viscosity * laplace_3d(v.vz, dx),
            vy=v.vy + dt * cfg.viscosity * laplace_3d(v.vy, dx),
            vx=v.vx + dt * cfg.viscosity * laplace_3d(v.vx, dx),
        )

    if force is not None:
        v = v + dt * force

    buoy = cfg.buoyancy if buoyancy_factor is None else buoyancy_factor
    if buoyancy_factor is not None or cfg.buoyancy:
        if getattr(buoy, "ndim", 0) >= 4 and buoy.shape[1] == density.shape[1]:
            # A full (B, D, H, W) field: weight the density at the centers,
            # then resample to z-faces.
            v = Staggered3D(vz=v.vz + dt * centered_to_z_faces(buoy * density),
                            vy=v.vy, vx=v.vx)
        else:
            v = Staggered3D(vz=v.vz + dt * buoy * centered_to_z_faces(density),
                            vy=v.vy, vx=v.vx)

    v, p = divergence_free_3d(v, domain, cfg, x0=state.pressure)
    return FluidState3D(velocity=v, density=density, inflow=state.inflow,
                        pressure=p if state.pressure is not None else None)
