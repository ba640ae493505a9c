"""Finite-difference stencils as shifted-slice arithmetic.

Counterpart of `pde_control_tpu/ops/stencils.py`. All ops are batched
(axis 0 untouched) and built from padding + slicing.

Boundary modes:
  * ``periodic``  — wrap.
  * ``neumann``   — zero normal derivative (edge replicate).
  * ``dirichlet`` — zero value outside (zero pad).
"""

from __future__ import annotations

import torch

_BOUNDARIES = ("periodic", "neumann", "dirichlet")


def pad_edge(u: torch.Tensor, axis: int, boundary: str) -> torch.Tensor:
    """Pad one cell on both sides of `axis` according to `boundary`."""
    if boundary not in _BOUNDARIES:
        raise ValueError(f"unknown boundary {boundary!r}")
    n = u.shape[axis]
    if boundary == "periodic":
        lo, hi = u.narrow(axis, n - 1, 1), u.narrow(axis, 0, 1)
    elif boundary == "neumann":
        lo, hi = u.narrow(axis, 0, 1), u.narrow(axis, n - 1, 1)
    else:
        lo = hi = torch.zeros_like(u.narrow(axis, 0, 1))
    return torch.cat([lo, u, hi], dim=axis)


def _shift_diff2(u: torch.Tensor, axis: int, boundary: str) -> torch.Tensor:
    """u[i+1] + u[i-1] - 2 u[i] along `axis` with boundary handling."""
    up = pad_edge(u, axis, boundary)
    n = u.shape[axis]
    lo = up.narrow(axis, 0, n)      # u[i-1]
    hi = up.narrow(axis, 2, n)      # u[i+1]
    return lo + hi - 2.0 * u


def laplace(
    u: torch.Tensor,
    dx: float = 1.0,
    boundary: str = "periodic",
    axes: tuple[int, ...] | None = None,
) -> torch.Tensor:
    """Discrete Laplacian Σ_ax (u[i+1]+u[i-1]-2u[i])/dx² over spatial `axes`.

    `axes` defaults to all axes except axis 0 (the batch axis).
    """
    if axes is None:
        axes = tuple(range(1, u.ndim))
    out = torch.zeros_like(u)
    for ax in axes:
        out = out + _shift_diff2(u, ax, boundary)
    return out / (dx * dx)
