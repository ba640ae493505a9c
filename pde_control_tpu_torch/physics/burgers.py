"""1D Burgers equation: u_t + u·u_x = ν·u_xx + F.

Counterpart of `pde_control_tpu/physics/burgers.py`: semi-Lagrangian
self-advection followed by explicit diffusion, with the control force
applied as +dt·F per step. State is a (B, N) tensor, a batch of 1D
velocity fields.
"""

from __future__ import annotations

import dataclasses

import torch

from pde_control_tpu_torch.ops.interp import linear_sample_1d
from pde_control_tpu_torch.ops.stencils import laplace


@dataclasses.dataclass(frozen=True)
class BurgersConfig:
    """Static solver parameters. Explicit diffusion is stable while
    ν·dt/dx² < 0.5."""

    n: int = 32
    dx: float = 1.0
    dt: float = 1.0
    viscosity: float = 0.1
    boundary: str = "periodic"  # 'periodic' | 'neumann'

    @property
    def sample_boundary(self) -> str:
        return "periodic" if self.boundary == "periodic" else "clamp"


def burgers_step(u: torch.Tensor, force: torch.Tensor | None,
                 cfg: BurgersConfig) -> torch.Tensor:
    """One differentiable Burgers step.

    Args:
      u: (B, N) velocity.
      force: (B, N) control force F(x, t), or None; applied as +dt·F.
      cfg: solver config.
    Returns: (B, N) next velocity.
    """
    n = u.shape[-1]
    x = torch.arange(n, dtype=u.dtype, device=u.device)[None, :]
    pts = x - cfg.dt * u / cfg.dx
    u_adv = linear_sample_1d(u, pts, cfg.sample_boundary)
    u_new = u_adv + cfg.dt * cfg.viscosity * laplace(u_adv, cfg.dx,
                                                     cfg.boundary)
    if force is not None:
        u_new = u_new + cfg.dt * force
    return u_new
