"""Grid types: staggered (MAC) velocity and simulation domains, in PyTorch.

Counterpart of `pde_control_tpu/grids.py`. Centered scalar fields are raw
``(B, H, W)`` tensors; a ``Staggered2D`` over an H×W cell grid holds
vy: (B, H+1, W) and vx: (B, H, W+1).

Coordinate convention (grid-index units, dx multiplies outside):
  * centered value  c[b, i, j]   at (y=i,     x=j)
  * y-face value    vy[b, i, j]  at (y=i-0.5, x=j),   i in 0..H
  * x-face value    vx[b, i, j]  at (y=i,     x=j-0.5), j in 0..W
"""

from __future__ import annotations

import dataclasses

import torch

from pde_control_tpu_torch.ops.interp import bilinear_sample_2d


def resolve_device(device=None) -> torch.device:
    """`device`, or the GPU when it is None. The port's constructors build
    on the card unless the caller asks for another device; without a card
    they raise rather than fall back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port builds on the GPU by "
                           "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass
class Staggered2D:
    """MAC-grid velocity: vy (B, H+1, W), vx (B, H, W+1)."""

    vy: torch.Tensor
    vx: torch.Tensor

    @property
    def grid_shape(self) -> tuple[int, int]:
        return self.vx.shape[-2], self.vy.shape[-1]  # (H, W)

    @property
    def batch(self) -> int:
        return self.vy.shape[0]

    def at_centers(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Average face values to cell centers → (vy_c, vx_c), each (B, H, W)."""
        vy_c = 0.5 * (self.vy[:, :-1, :] + self.vy[:, 1:, :])
        vx_c = 0.5 * (self.vx[:, :, :-1] + self.vx[:, :, 1:])
        return vy_c, vx_c

    def divergence(self, dx: float = 1.0) -> torch.Tensor:
        """Per-cell divergence, (B, H, W)."""
        dvy = self.vy[:, 1:, :] - self.vy[:, :-1, :]
        dvx = self.vx[:, :, 1:] - self.vx[:, :, :-1]
        return (dvy + dvx) / dx

    def sample_at(self, y: torch.Tensor, x: torch.Tensor,
                  boundary: str = "clamp") -> tuple[torch.Tensor, torch.Tensor]:
        """Bilinearly sample both components at physical coords (y, x)."""
        vy = bilinear_sample_2d(self.vy, y + 0.5, x, boundary)
        vx = bilinear_sample_2d(self.vx, y, x + 0.5, boundary)
        return vy, vx

    def __add__(self, other: "Staggered2D") -> "Staggered2D":
        return Staggered2D(self.vy + other.vy, self.vx + other.vx)

    def __sub__(self, other: "Staggered2D") -> "Staggered2D":
        return Staggered2D(self.vy - other.vy, self.vx - other.vx)

    def __mul__(self, s) -> "Staggered2D":
        return Staggered2D(self.vy * s, self.vx * s)

    __rmul__ = __mul__

    @classmethod
    def zeros(cls, batch: int, h: int, w: int, dtype=torch.float32,
              device=None) -> "Staggered2D":
        """Zero velocity on `device` (the GPU when None)."""
        device = resolve_device(device)
        return cls(
            vy=torch.zeros((batch, h + 1, w), dtype=dtype, device=device),
            vx=torch.zeros((batch, h, w + 1), dtype=dtype, device=device),
        )


def _pad1(c: torch.Tensor, dim: int, boundary: str) -> torch.Tensor:
    """One cell of edge (clamp) or wrap (periodic) padding on both sides."""
    n = c.shape[dim]
    if boundary == "periodic":
        lo, hi = c.narrow(dim, n - 1, 1), c.narrow(dim, 0, 1)
    else:
        lo, hi = c.narrow(dim, 0, 1), c.narrow(dim, n - 1, 1)
    return torch.cat([lo, c, hi], dim=dim)


def centered_to_y_faces(c: torch.Tensor, boundary: str = "clamp") -> torch.Tensor:
    """Resample a centered field (B, H, W) to y-faces (B, H+1, W).

    Interior faces average adjacent cells; boundary faces replicate (clamp)
    or wrap (periodic).
    """
    cp = _pad1(c, 1, boundary)
    return 0.5 * (cp[:, :-1, :] + cp[:, 1:, :])


def centered_to_x_faces(c: torch.Tensor, boundary: str = "clamp") -> torch.Tensor:
    """Resample a centered field (B, H, W) to x-faces (B, H, W+1)."""
    cp = _pad1(c, 2, boundary)
    return 0.5 * (cp[:, :, :-1] + cp[:, :, 1:])


@dataclasses.dataclass
class Domain2D:
    """Simulation domain: grid size, cell size, wall boundary, obstacle masks.

    Attributes:
      fluid_mask: (H, W) float, 1 = fluid cell, 0 = solid/obstacle.
      acc_y: (H+1, W) float, 1 = y-face open to flow.
      acc_x: (H, W+1) float, 1 = x-face open to flow.
      dx: cell size.
      closed: True → solid walls (v·n = 0, Neumann pressure);
              False → open boundary (Dirichlet p = 0 at walls).
      has_obstacles: set by `create`; lets the pressure solve pick the
        exact spectral path when there are none.
    """

    fluid_mask: torch.Tensor
    acc_y: torch.Tensor
    acc_x: torch.Tensor
    dx: float = 1.0
    closed: bool = True
    has_obstacles: bool = False

    @property
    def grid_shape(self) -> tuple[int, int]:
        return self.fluid_mask.shape[-2], self.fluid_mask.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.fluid_mask.device

    @classmethod
    def create(
        cls,
        h: int,
        w: int,
        obstacle_mask=None,
        dx: float = 1.0,
        closed: bool = True,
        dtype=torch.float32,
        device=None,
    ) -> "Domain2D":
        """Build a domain from an optional obstacle mask (1 = solid); the
        mask may be a numpy array or a tensor. The masks go to `device`,
        the GPU when None (see `resolve_device`)."""
        device = resolve_device(device)
        if obstacle_mask is None:
            fluid = torch.ones((h, w), dtype=dtype, device=device)
            has_obstacles = False
        else:
            obs = torch.as_tensor(obstacle_mask)
            has_obstacles = bool((obs > 0).any())
            fluid = 1.0 - obs.to(dtype=dtype, device=device)
        # Interior faces open iff both adjacent cells are fluid.
        acc_y_int = fluid[:-1, :] * fluid[1:, :]          # (H-1, W)
        acc_x_int = fluid[:, :-1] * fluid[:, 1:]          # (H, W-1)
        # Wall faces: blocked when closed; open-domain walls are open where
        # the adjacent edge cell is fluid.
        wall = 0.0 if closed else 1.0
        acc_y = torch.cat([wall * fluid[:1, :], acc_y_int, wall * fluid[-1:, :]],
                          dim=0)
        acc_x = torch.cat([wall * fluid[:, :1], acc_x_int, wall * fluid[:, -1:]],
                          dim=1)
        return cls(fluid_mask=fluid, acc_y=acc_y, acc_x=acc_x, dx=dx,
                   closed=closed, has_obstacles=has_obstacles)

    def mask_velocity(self, v: Staggered2D) -> Staggered2D:
        """Zero velocity on blocked faces (walls + obstacle faces)."""
        return Staggered2D(vy=v.vy * self.acc_y, vx=v.vx * self.acc_x)

    def pressure_gradient(self, p: torch.Tensor) -> Staggered2D:
        """∇p on faces, gated by accessibility. p: (B, H, W).

        Interior face: (p_hi − p_lo)/dx. Wall faces: 0 when closed; when
        open, pressure is 0 outside so the face gradient is ±p_edge/dx.
        """
        dx = self.dx
        if self.closed:
            zy = torch.zeros_like(p[:, :1, :])
            gy = torch.cat([zy, (p[:, 1:, :] - p[:, :-1, :]) / dx, zy], dim=1)
            zx = torch.zeros_like(p[:, :, :1])
            gx = torch.cat([zx, (p[:, :, 1:] - p[:, :, :-1]) / dx, zx], dim=2)
        else:
            pp = torch.nn.functional.pad(p, (0, 0, 1, 1))
            gy = (pp[:, 1:, :] - pp[:, :-1, :]) / dx
            pp = torch.nn.functional.pad(p, (1, 1))
            gx = (pp[:, :, 1:] - pp[:, :, :-1]) / dx
        return Staggered2D(vy=gy * self.acc_y, vx=gx * self.acc_x)
