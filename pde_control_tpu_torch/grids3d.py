"""3D grid types: staggered (MAC) velocity and simulation domains, in PyTorch.

Counterpart of `pde_control_tpu/grids3d.py`. Coordinate convention
(grid-index units; z is "up": buoyancy acts on vz):
  * centered value  c[b, k, i, j]   at (z=k,     y=i,     x=j)
  * z-face value    vz[b, k, i, j]  at (z=k-0.5, y=i,     x=j),   k in 0..D
  * y-face value    vy[b, k, i, j]  at (z=k,     y=i-0.5, x=j),   i in 0..H
  * x-face value    vx[b, k, i, j]  at (z=k,     y=i,     x=j-0.5), j in 0..W

so a ``Staggered3D`` over a D×H×W cell grid holds vz: (B, D+1, H, W),
vy: (B, D, H+1, W), vx: (B, D, H, W+1), the layout the masked pressure
projection assumes, as in 2D. `Domain3D` has the surface of `Domain2D`
that `physics/poisson.py` uses (`fluid_mask`, `pressure_gradient`, `dx`,
`closed`, `has_obstacles`), so the pressure solve serves both.
"""

from __future__ import annotations

import dataclasses

import torch

from pde_control_tpu_torch.grids import _pad1, resolve_device


@dataclasses.dataclass
class Staggered3D:
    """MAC-grid velocity: vz (B, D+1, H, W), vy (B, D, H+1, W),
    vx (B, D, H, W+1)."""

    vz: torch.Tensor
    vy: torch.Tensor
    vx: torch.Tensor

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return self.vy.shape[-3], self.vx.shape[-2], self.vz.shape[-1]

    @property
    def batch(self) -> int:
        return self.vz.shape[0]

    def at_centers(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Average face values to cell centers → (vz_c, vy_c, vx_c)."""
        vz_c = 0.5 * (self.vz[:, :-1] + self.vz[:, 1:])
        vy_c = 0.5 * (self.vy[:, :, :-1] + self.vy[:, :, 1:])
        vx_c = 0.5 * (self.vx[:, :, :, :-1] + self.vx[:, :, :, 1:])
        return vz_c, vy_c, vx_c

    def divergence(self, dx: float = 1.0) -> torch.Tensor:
        """Per-cell divergence, (B, D, H, W)."""
        dvz = self.vz[:, 1:] - self.vz[:, :-1]
        dvy = self.vy[:, :, 1:] - self.vy[:, :, :-1]
        dvx = self.vx[:, :, :, 1:] - self.vx[:, :, :, :-1]
        return (dvz + dvy + dvx) / dx

    def __add__(self, other: "Staggered3D") -> "Staggered3D":
        return Staggered3D(self.vz + other.vz, self.vy + other.vy,
                           self.vx + other.vx)

    def __sub__(self, other: "Staggered3D") -> "Staggered3D":
        return Staggered3D(self.vz - other.vz, self.vy - other.vy,
                           self.vx - other.vx)

    def __mul__(self, s) -> "Staggered3D":
        return Staggered3D(self.vz * s, self.vy * s, self.vx * s)

    __rmul__ = __mul__

    @classmethod
    def zeros(cls, batch: int, d: int, h: int, w: int, dtype=torch.float32,
              device=None) -> "Staggered3D":
        """Zero velocity on `device` (the GPU when None)."""
        device = resolve_device(device)
        return cls(
            vz=torch.zeros((batch, d + 1, h, w), dtype=dtype, device=device),
            vy=torch.zeros((batch, d, h + 1, w), dtype=dtype, device=device),
            vx=torch.zeros((batch, d, h, w + 1), dtype=dtype, device=device),
        )


def _face_resample(c: torch.Tensor, axis: int, boundary: str) -> torch.Tensor:
    """Centered (B, D, H, W) → faces along `axis` (size + 1 there): interior
    faces average the adjacent cells, boundary faces replicate (clamp) or
    wrap (periodic)."""
    cp = _pad1(c, axis, boundary)
    n = cp.shape[axis]
    return 0.5 * (cp.narrow(axis, 0, n - 1) + cp.narrow(axis, 1, n - 1))


def centered_to_z_faces(c: torch.Tensor, boundary: str = "clamp") -> torch.Tensor:
    return _face_resample(c, 1, boundary)


def centered_to_y_faces_3d(c: torch.Tensor,
                           boundary: str = "clamp") -> torch.Tensor:
    return _face_resample(c, 2, boundary)


def centered_to_x_faces_3d(c: torch.Tensor,
                           boundary: str = "clamp") -> torch.Tensor:
    return _face_resample(c, 3, boundary)


@dataclasses.dataclass
class Domain3D:
    """3D simulation domain.

    Attributes:
      fluid_mask: (D, H, W) float, 1 = fluid cell, 0 = solid/obstacle.
      acc_z/acc_y/acc_x: face accessibility (1 = open to flow), shaped like
        the corresponding Staggered3D component (minus batch).
      dx, closed, has_obstacles: as `Domain2D`'s.
    """

    fluid_mask: torch.Tensor
    acc_z: torch.Tensor
    acc_y: torch.Tensor
    acc_x: torch.Tensor
    dx: float = 1.0
    closed: bool = True
    has_obstacles: bool = False

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return tuple(self.fluid_mask.shape[-3:])

    @property
    def device(self) -> torch.device:
        return self.fluid_mask.device

    @classmethod
    def create(
        cls,
        d: int,
        h: int,
        w: int,
        obstacle_mask=None,
        dx: float = 1.0,
        closed: bool = True,
        dtype=torch.float32,
        device=None,
    ) -> "Domain3D":
        """Build a domain from an optional (D, H, W) obstacle mask (1 =
        solid; numpy or tensor) on `device`, the GPU when None (see
        `resolve_device`)."""
        device = resolve_device(device)
        if obstacle_mask is None:
            fluid = torch.ones((d, h, w), dtype=dtype, device=device)
            has_obstacles = False
        else:
            obs = torch.as_tensor(obstacle_mask)
            has_obstacles = bool((obs > 0).any())
            fluid = 1.0 - obs.to(dtype=dtype, device=device)
        wall = 0.0 if closed else 1.0

        def acc(axis: int) -> torch.Tensor:
            n = fluid.shape[axis]
            interior = fluid.narrow(axis, 0, n - 1) * fluid.narrow(axis, 1, n - 1)
            return torch.cat([wall * fluid.narrow(axis, 0, 1), interior,
                              wall * fluid.narrow(axis, n - 1, 1)], dim=axis)

        return cls(fluid_mask=fluid, acc_z=acc(0), acc_y=acc(1), acc_x=acc(2),
                   dx=dx, closed=closed, has_obstacles=has_obstacles)

    def mask_velocity(self, v: Staggered3D) -> Staggered3D:
        """Zero velocity on blocked faces (walls + obstacle faces)."""
        return Staggered3D(vz=v.vz * self.acc_z, vy=v.vy * self.acc_y,
                           vx=v.vx * self.acc_x)

    def pressure_gradient(self, p: torch.Tensor) -> Staggered3D:
        """∇p on faces, gated by accessibility. p: (B, D, H, W). Wall
        faces: 0 when closed; when open, pressure is 0 outside."""
        dx = self.dx

        def grad(axis: int) -> torch.Tensor:
            n = p.shape[axis]
            if self.closed:
                g_int = (p.narrow(axis, 1, n - 1) - p.narrow(axis, 0, n - 1)) / dx
                z = torch.zeros_like(p.narrow(axis, 0, 1))
                return torch.cat([z, g_int, z], dim=axis)
            z = torch.zeros_like(p.narrow(axis, 0, 1))
            pp = torch.cat([z, p, z], dim=axis)
            return (pp.narrow(axis, 1, n + 1) - pp.narrow(axis, 0, n + 1)) / dx

        return Staggered3D(vz=grad(1) * self.acc_z, vy=grad(2) * self.acc_y,
                           vx=grad(3) * self.acc_x)
