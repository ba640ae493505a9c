"""Semi-Lagrangian advection for centered and staggered fields.

Counterpart of `pde_control_tpu/physics/advect.py`: backtrace sample
points by −dt·v, then resample the advected field. Two resampling modes:
  * ``shift``  — the shift-stencil bilinear sampler (valid while
    |v·dt/dx| ≤ ``max_shift`` cells; larger displacements are clipped).
    Default, and the only mode of the fused step.
  * ``gather`` — the gather-based bilinear sampler at any displacement.
"""

from __future__ import annotations

import torch

from pde_control_tpu_torch.grids import (
    Staggered2D,
    centered_to_x_faces,
    centered_to_y_faces,
)
from pde_control_tpu_torch.ops.interp import (
    bilinear_sample_2d,
    shift_bilinear_sample_2d,
)


def _resample_displaced(field: torch.Tensor, disp_y: torch.Tensor,
                        disp_x: torch.Tensor, mode: str, max_shift: int,
                        boundary: str) -> torch.Tensor:
    """Sample `field` at (grid + disp) with the chosen sampler."""
    if mode == "shift":
        return shift_bilinear_sample_2d(field, disp_y, disp_x, max_shift,
                                        boundary)
    if mode == "gather":
        _, h, w = field.shape
        iy = torch.arange(h, dtype=field.dtype, device=field.device)[None, :, None]
        ix = torch.arange(w, dtype=field.dtype, device=field.device)[None, None, :]
        return bilinear_sample_2d(field, iy + disp_y, ix + disp_x, boundary)
    raise ValueError(f"unknown advection mode {mode!r}")


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
    vy_c, vx_c = v.at_centers()
    disp_y = -dt * vy_c / dx
    disp_x = -dt * vx_c / dx
    return _resample_displaced(c, disp_y, disp_x, mode, max_shift, boundary)


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
    vy_c, vx_c = v.at_centers()
    vx_at_y = centered_to_y_faces(vx_c, boundary="clamp")
    vy_new = _resample_displaced(
        v.vy, -dt * v.vy / dx, -dt * vx_at_y / dx, mode, max_shift, boundary)
    vy_at_x = centered_to_x_faces(vy_c, boundary="clamp")
    vx_new = _resample_displaced(
        v.vx, -dt * vy_at_x / dx, -dt * v.vx / dx, mode, max_shift, boundary)
    return Staggered2D(vy=vy_new, vx=vx_new)
