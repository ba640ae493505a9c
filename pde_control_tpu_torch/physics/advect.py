"""Semi-Lagrangian advection for centered and staggered fields.

Counterpart of `pde_control_tpu/physics/advect.py`, shift mode only:
backtrace sample points by −dt·v, then resample with the shift-stencil
bilinear sampler (valid while |v·dt/dx| ≤ ``max_shift`` cells; larger
displacements are clipped).
"""

from __future__ import annotations

import torch

from pde_control_tpu_torch.grids import (
    Staggered2D,
    centered_to_x_faces,
    centered_to_y_faces,
)
from pde_control_tpu_torch.ops.interp import shift_bilinear_sample_2d


def _check_mode(mode: str) -> None:
    if mode != "shift":
        raise ValueError(f"advection mode {mode!r} is not ported; use 'shift'")


def advect_centered(
    c: torch.Tensor,
    v: Staggered2D,
    dt: float,
    dx: float = 1.0,
    mode: str = "shift",
    max_shift: int = 2,
    boundary: str = "clamp",
) -> torch.Tensor:
    """Advect a centered field (B, H, W) through velocity v for time dt."""
    _check_mode(mode)
    vy_c, vx_c = v.at_centers()
    disp_y = -dt * vy_c / dx
    disp_x = -dt * vx_c / dx
    return shift_bilinear_sample_2d(c, disp_y, disp_x, max_shift, boundary)


def advect_staggered(
    v: Staggered2D,
    dt: float,
    dx: float = 1.0,
    mode: str = "shift",
    max_shift: int = 2,
    boundary: str = "clamp",
) -> Staggered2D:
    """Self-advect a staggered velocity field (each component at its faces).

    The transverse velocity component at each face is approximated by
    center-averaging then face-resampling.
    """
    _check_mode(mode)
    vy_c, vx_c = v.at_centers()
    vx_at_y = centered_to_y_faces(vx_c, boundary="clamp")
    vy_new = shift_bilinear_sample_2d(
        v.vy, -dt * v.vy / dx, -dt * vx_at_y / dx, max_shift, boundary)
    vy_at_x = centered_to_x_faces(vy_c, boundary="clamp")
    vx_new = shift_bilinear_sample_2d(
        v.vx, -dt * vy_at_x / dx, -dt * v.vx / dx, max_shift, boundary)
    return Staggered2D(vy=vy_new, vx=vx_new)
