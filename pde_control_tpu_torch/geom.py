"""Geometry primitives → grid masks.

Counterpart of `pde_control_tpu/geom.py`: `Box`, `Sphere` and `union`
rasterize to cell-centered occupancy masks and signed distance fields,
used for obstacles, initial smoke shapes and force-mask regions. Cell
(i, j) has its center at (y=i, x=j) in grid-index units, as in grids.py.

Everything returns float32 tensors on an explicit device (the GPU when
None, see `grids.resolve_device`); a shape's parameters may be Python
numbers or tensors that broadcast against the (H, W) grid.
"""

from __future__ import annotations

import dataclasses

import torch

from pde_control_tpu_torch.grids import resolve_device


@dataclasses.dataclass(frozen=True)
class Box:
    """Axis-aligned box: [y0, y1) × [x0, x1) in grid-index units."""

    y0: float
    x0: float
    y1: float
    x1: float

    def sdf(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        cy = (self.y0 + self.y1) / 2.0
        cx = (self.x0 + self.x1) / 2.0
        hy = (self.y1 - self.y0) / 2.0
        hx = (self.x1 - self.x0) / 2.0
        dy = torch.abs(y - cy) - hy
        dx = torch.abs(x - cx) - hx
        outside = torch.sqrt(torch.clamp(dy, min=0) ** 2
                             + torch.clamp(dx, min=0) ** 2)
        inside = torch.clamp(torch.maximum(dy, dx), max=0)
        return outside + inside


@dataclasses.dataclass(frozen=True)
class Sphere:
    """Circle (2D sphere): center (cy, cx), radius r, grid-index units."""

    cy: float
    cx: float
    r: float

    def sdf(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt((y - self.cy) ** 2 + (x - self.cx) ** 2) - self.r


@dataclasses.dataclass(frozen=True)
class Union:
    """Union of shapes (min of SDFs)."""

    shapes: tuple

    def sdf(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        d = self.shapes[0].sdf(y, x)
        for s in self.shapes[1:]:
            d = torch.minimum(d, s.sdf(y, x))
        return d


def union(*shapes) -> Union:
    return Union(tuple(shapes))


def _grid_coords(h: int, w: int, device):
    device = resolve_device(device)
    y = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    x = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return y.expand(h, w), x.expand(h, w)


def rasterize(shape, h: int, w: int, smooth: float = 0.0,
              device=None) -> torch.Tensor:
    """Occupancy mask (H, W): 1 inside the shape, 0 outside.

    smooth > 0 gives a soft edge of that width (for differentiable
    initial-density shapes; obstacles stay hard, smooth=0).
    """
    d = shape.sdf(*_grid_coords(h, w, device))
    if smooth > 0:
        return torch.clamp(0.5 - d / smooth, 0.0, 1.0)
    # Boundary-inclusive: a cell center exactly on the zero level set is
    # solid, so a Box whose bounds land on integer centers covers one row
    # more than y1 - y0.
    return (d <= 0).to(torch.float32)


def sdf_grid(shape, h: int, w: int, device=None) -> torch.Tensor:
    """Signed distance sampled at cell centers (H, W)."""
    return shape.sdf(*_grid_coords(h, w, device))
