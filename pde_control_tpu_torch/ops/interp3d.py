"""Trilinear field sampling — the 3D semi-Lagrangian advection core.

Counterpart of `pde_control_tpu/ops/interp3d.py`: `trilinear_sample_3d`
gathers at the eight corners of floor(z), floor(y), floor(x)
(advection_mode='gather'; the gradient flows through the fractional parts
and the gathers, floor's is zero), and `shift_trilinear_sample_3d` samples
at ``grid + displacement`` with ``|displacement| <= max_shift`` cells as a
weighted sum over a static (2K+2)³ window of shifted copies of the field
(K = 1 by default: 64 terms).

The shift sampler's gradient is written out by hand (`_ShiftSample3D`), as
the 2D one's is (`ops/interp.py :: _ShiftSample`), with JAX's subgradients
at the tie points, where the training sits (velocity and the CFE's output
layer start at zero, so every displacement is exactly 0 in the first
step):
  * d/dd max(0, 1-|d|) = -sign(d) with sign(0) = +1, and ∓0.5 at |d| = 1;
  * d clip(d, -k, k)/dd = 1 inside, 0.5 at the bound, 0 outside.

Coordinate convention: value ``field[..., k, i, j]`` sits at
``(z=k, y=i, x=j)`` in grid-index units.
"""

from __future__ import annotations

import torch

from pde_control_tpu_torch.ops.interp import (
    _clip_grad,
    _hat,
    _hat_grad,
    _pad_index,
    _wrap_or_clip,
)


def trilinear_sample_3d(field: torch.Tensor, z: torch.Tensor, y: torch.Tensor,
                        x: torch.Tensor, boundary: str = "clamp"
                        ) -> torch.Tensor:
    """Sample a batched 3D field at fractional coordinates (gather-based).

    Args:
      field: (B, D, H, W); field[b, k, i, j] at (z=k, y=i, x=j).
      z, y, x: (B, ...) sample coordinates (same trailing shape).
      boundary: 'periodic' or 'clamp'.
    Returns: (B, ...) sampled values.
    """
    b, d, h, w = field.shape
    out_shape = z.shape
    z, y, x = (c.reshape(b, -1) for c in (z, y, x))
    z0f, y0f, x0f = torch.floor(z), torch.floor(y), torch.floor(x)
    fz, fy, fx = z - z0f, y - y0f, x - x0f
    z0, y0, x0 = z0f.long(), y0f.long(), x0f.long()
    flat = field.reshape(b, d * h * w)

    def gather(iz, iy, ix):
        iz = _wrap_or_clip(iz, d, boundary)
        iy = _wrap_or_clip(iy, h, boundary)
        ix = _wrap_or_clip(ix, w, boundary)
        return torch.gather(flat, -1, (iz * h + iy) * w + ix)

    out = torch.zeros_like(fz)
    for oz in (0, 1):
        wz = fz if oz else (1.0 - fz)
        for oy in (0, 1):
            wy = fy if oy else (1.0 - fy)
            for ox in (0, 1):
                wx = fx if ox else (1.0 - fx)
                out = out + gather(z0 + oz, y0 + oy, x0 + ox) * (wz * wy * wx)
    return out.reshape(b, *out_shape[1:]) if len(out_shape) > 1 else out


def _pad3(field: torch.Tensor, k: int, boundary: str) -> torch.Tensor:
    """Pad the last three axes by (k, k + 1), edge (clamp) or wrap."""
    d, h, w = field.shape[-3:]
    dev = field.device
    return (field.index_select(-3, _pad_index(d, k, boundary, dev))
            .index_select(-2, _pad_index(h, k, boundary, dev))
            .index_select(-1, _pad_index(w, k, boundary, dev)))


def _pad3_T(gp: torch.Tensor, shape: tuple, k: int,
            boundary: str) -> torch.Tensor:
    """Adjoint of `_pad3`: fold the padded margins back onto their source
    cells."""
    out = gp
    for axis, n in zip((-3, -2, -1), shape):
        idx = _pad_index(n, k, boundary, gp.device)
        size = list(out.shape)
        size[axis] = n
        folded = out.new_zeros(size)
        folded.index_add_(out.dim() + axis, idx, out)
        out = folded
    return out


class _ShiftSample3D(torch.autograd.Function):
    """out = Σ_(oz,oy,ox) shift(field) · hat(dz−oz) · hat(dy−oy) · hat(dx−ox),
    with the displacements clipped to ±k; backward with JAX's tie rules."""

    @staticmethod
    def forward(ctx, field, disp_z, disp_y, disp_x, k: int, boundary: str):
        ctx.save_for_backward(field, disp_z, disp_y, disp_x)
        ctx.k, ctx.boundary = k, boundary
        dzc, dyc, dxc = (torch.clamp(t, -k, k) for t in (disp_z, disp_y, disp_x))
        fp = _pad3(field, k, boundary)
        d, h, w = field.shape[-3:]
        offs = range(-k, k + 2)
        wys = [_hat(dyc - o) for o in offs]
        wxs = [_hat(dxc - o) for o in offs]
        out = torch.zeros_like(field)
        for oz in offs:
            wz = _hat(dzc - oz)
            plane = fp[..., k + oz:k + oz + d, :, :]
            for iy, oy in enumerate(offs):
                row = plane[..., k + oy:k + oy + h, :]
                for ix, ox in enumerate(offs):
                    val = row[..., k + ox:k + ox + w]
                    out = out + val * (wz * wys[iy] * wxs[ix])
        return out

    @staticmethod
    def backward(ctx, g):
        field, disp_z, disp_y, disp_x = ctx.saved_tensors
        k, boundary = ctx.k, ctx.boundary
        dzc, dyc, dxc = (torch.clamp(t, -k, k) for t in (disp_z, disp_y, disp_x))
        fp = _pad3(field, k, boundary)
        d, h, w = field.shape[-3:]
        offs = range(-k, k + 2)
        wys = [_hat(dyc - o) for o in offs]
        wxs = [_hat(dxc - o) for o in offs]
        wyps = [_hat_grad(dyc - o) for o in offs]
        wxps = [_hat_grad(dxc - o) for o in offs]
        gp = torch.zeros_like(fp)
        s_dz, s_dy, s_dx = (torch.zeros_like(field) for _ in range(3))
        for oz in offs:
            wz = _hat(dzc - oz)
            wzp = _hat_grad(dzc - oz)
            plane = fp[..., k + oz:k + oz + d, :, :]
            for iy, oy in enumerate(offs):
                row = plane[..., k + oy:k + oy + h, :]
                gzy = g * wz * wys[iy]
                for ix, ox in enumerate(offs):
                    val = row[..., k + ox:k + ox + w]
                    gp[..., k + oz:k + oz + d, k + oy:k + oy + h,
                       k + ox:k + ox + w] += gzy * wxs[ix]
                    s_dz = s_dz + val * (wzp * wys[iy] * wxs[ix])
                    s_dy = s_dy + val * (wz * wyps[iy] * wxs[ix])
                    s_dx = s_dx + val * (wz * wys[iy] * wxps[ix])
        g_field = _pad3_T(gp, (d, h, w), k, boundary)
        return (g_field, g * s_dz * _clip_grad(disp_z, k),
                g * s_dy * _clip_grad(disp_y, k),
                g * s_dx * _clip_grad(disp_x, k), None, None)


def shift_trilinear_sample_3d(
    field: torch.Tensor,
    disp_z: torch.Tensor,
    disp_y: torch.Tensor,
    disp_x: torch.Tensor,
    max_shift: int = 1,
    boundary: str = "clamp",
) -> torch.Tensor:
    """Trilinear sample at ``grid + displacement`` without gathers.

    out[k,i,j] = trilerp(field, k+disp_z, i+disp_y, j+disp_x) assuming
    |disp| <= max_shift (displacement is clipped to that bound).

    Args:
      field: (B, D, H, W).
      disp_z/y/x: (B, D, H, W) displacements in cells.
      max_shift: CFL bound K on |displacement| (window is (2K+2)³ terms).
      boundary: 'clamp' or 'periodic'.
    """
    if boundary not in ("clamp", "periodic"):
        raise ValueError(f"unknown sampling boundary {boundary!r}")
    return _ShiftSample3D.apply(field, disp_z, disp_y, disp_x, int(max_shift),
                                boundary)
