"""Linear and bilinear sampling — the semi-Lagrangian advection core.

Counterpart of `pde_control_tpu/ops/interp.py :: linear_sample_1d,
bilinear_sample_2d, shift_bilinear_sample_2d`. `linear_sample_1d`
(Burgers) gathers at floor(x) and floor(x) + 1, and `bilinear_sample_2d`
(advection_mode='gather') at the four corners of floor(y), floor(x); their
gradients flow through the fractional parts and the gathers (a
scatter-add), floor's is zero, as in JAX, so a coordinate on an exact
integer takes the cell it names as its lower corner. On the card the
scatter-add is atomic, so its bits may change from call to call.

When sample points are ``grid + displacement`` with ``|displacement| <=
max_shift`` cells, bilinear interpolation is a weighted sum over a static
(2K+2)² window of shifted copies of the field.

The gradient is written out by hand (`_ShiftSample`) because autograd's
subgradients at tie points differ from JAX's, and the main path sits on
those ties: velocity starts at zero and the CFE's output layer starts at
zero, so every displacement is exactly 0 in the first step. The rules,
as in `pde_control_tpu/ops/pallas_fluid.py :: _hat_grad, _clip_grad`:
  * d/dd max(0, 1-|d|) = -sign(d) with sign(0) = +1, and ∓0.5 at |d| = 1;
  * d clip(d, -k, k)/dd = 1 inside, 0.5 at the bound, 0 outside.

Coordinate convention: value ``field[..., i, j]`` sits at (y=i, x=j).
Boundary modes: ``clamp`` (edge replicate) and ``periodic``.
"""

from __future__ import annotations

import torch


def _wrap_or_clip(idx: torch.Tensor, n: int, boundary: str) -> torch.Tensor:
    if boundary == "periodic":
        return torch.remainder(idx, n)  # jnp.mod's sign on negative indices
    if boundary == "clamp":
        return idx.clamp(0, n - 1)
    raise ValueError(f"unknown sampling boundary {boundary!r}")


def linear_sample_1d(field: torch.Tensor, x: torch.Tensor,
                     boundary: str = "periodic") -> torch.Tensor:
    """Sample a batched 1D field at fractional coordinates.

    Args:
      field: (B, N) values; field[b, i] at coordinate i.
      x: (B, M) fractional sample coordinates.
      boundary: 'periodic' or 'clamp'.
    Returns: (B, M) sampled values.
    """
    n = field.shape[-1]
    x0 = torch.floor(x)
    f = x - x0
    i = x0.long()
    v0 = torch.gather(field, -1, _wrap_or_clip(i, n, boundary))
    v1 = torch.gather(field, -1, _wrap_or_clip(i + 1, n, boundary))
    return v0 * (1.0 - f) + v1 * f


def bilinear_sample_2d(field: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                       boundary: str = "clamp") -> torch.Tensor:
    """Sample a batched 2D field at fractional coordinates (gather-based).

    Args:
      field: (B, H, W); field[b, i, j] at coordinate (y=i, x=j).
      y, x: (B, ...) sample coordinates (same trailing shape).
      boundary: 'periodic' or 'clamp'.
    Returns: (B, ...) sampled values.
    """
    b, h, w = field.shape
    out_shape = y.shape
    y = y.reshape(b, -1)
    x = x.reshape(b, -1)
    y0f = torch.floor(y)
    x0f = torch.floor(x)
    fy = y - y0f
    fx = x - x0f
    y0 = y0f.long()
    x0 = x0f.long()
    flat = field.reshape(b, h * w)

    def gather(iy, ix):
        iy = _wrap_or_clip(iy, h, boundary)
        ix = _wrap_or_clip(ix, w, boundary)
        return torch.gather(flat, -1, iy * w + ix)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    out = (v00 * (1 - fy) * (1 - fx)
           + v01 * (1 - fy) * fx
           + v10 * fy * (1 - fx)
           + v11 * fy * fx)
    return out.reshape(b, *out_shape[1:]) if len(out_shape) > 1 else out


def _hat(d: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(d), min=0.0)


def _hat_grad(d: torch.Tensor) -> torch.Tensor:
    """d/dd max(0, 1-|d|) with JAX's subgradients."""
    a = torch.abs(d)
    mag = torch.where(a < 1.0, 1.0, torch.where(a == 1.0, 0.5, 0.0))
    return torch.where(d >= 0, -mag, mag)


def _clip_grad(d: torch.Tensor, k: float) -> torch.Tensor:
    """d clip(d, -k, k)/dd with JAX's tie rule (0.5 at the bound)."""
    a = torch.abs(d)
    return torch.where(a < k, 1.0, torch.where(a == k, 0.5, 0.0)).to(d.dtype)


def _pad_index(n: int, k: int, boundary: str, device) -> torch.Tensor:
    """Source index of each of the n+2k+1 padded positions (pad k, k+1)."""
    idx = torch.arange(-k, n + k + 1, device=device)
    if boundary == "periodic":
        return torch.remainder(idx, n)
    if boundary == "clamp":
        return idx.clamp(0, n - 1)
    raise ValueError(f"unknown sampling boundary {boundary!r}")


def _pad2(field: torch.Tensor, k: int, boundary: str) -> torch.Tensor:
    h, w = field.shape[-2], field.shape[-1]
    iy = _pad_index(h, k, boundary, field.device)
    ix = _pad_index(w, k, boundary, field.device)
    return field.index_select(-2, iy).index_select(-1, ix)


def _pad2_T(gp: torch.Tensor, h: int, w: int, k: int,
            boundary: str) -> torch.Tensor:
    """Adjoint of `_pad2`: fold the padded margins back onto their source
    cells."""
    iy = _pad_index(h, k, boundary, gp.device)
    ix = _pad_index(w, k, boundary, gp.device)
    rows = gp.new_zeros(gp.shape[:-2] + (h, gp.shape[-1]))
    rows.index_add_(rows.ndim - 2, iy, gp)
    out = gp.new_zeros(gp.shape[:-2] + (h, w))
    out.index_add_(out.ndim - 1, ix, rows)
    return out


class _ShiftSample(torch.autograd.Function):
    """out = Σ_(oy,ox) shift(field) · hat(dy−oy) · hat(dx−ox), with the
    displacements clipped to ±k; backward with JAX's tie rules."""

    @staticmethod
    def forward(ctx, field, disp_y, disp_x, k: int, boundary: str):
        ctx.save_for_backward(field, disp_y, disp_x)
        ctx.k, ctx.boundary = k, boundary
        dyc = torch.clamp(disp_y, -k, k)
        dxc = torch.clamp(disp_x, -k, k)
        fp = _pad2(field, k, boundary)
        h, w = field.shape[-2], field.shape[-1]
        wxs = [_hat(dxc - ox) for ox in range(-k, k + 2)]
        out = torch.zeros_like(field)
        for oy in range(-k, k + 2):
            wy = _hat(dyc - oy)
            row = fp[..., k + oy:k + oy + h, :]
            for ix, ox in enumerate(range(-k, k + 2)):
                val = row[..., k + ox:k + ox + w]
                out = out + val * (wy * wxs[ix])
        return out

    @staticmethod
    def backward(ctx, g):
        field, disp_y, disp_x = ctx.saved_tensors
        k, boundary = ctx.k, ctx.boundary
        dyc = torch.clamp(disp_y, -k, k)
        dxc = torch.clamp(disp_x, -k, k)
        fp = _pad2(field, k, boundary)
        h, w = field.shape[-2], field.shape[-1]
        offs = range(-k, k + 2)
        wxs = [_hat(dxc - ox) for ox in offs]
        wxps = [_hat_grad(dxc - ox) for ox in offs]
        gp = torch.zeros_like(fp)
        s_dy = torch.zeros_like(field)
        s_dx = torch.zeros_like(field)
        for oy in offs:
            wy = _hat(dyc - oy)
            wyp = _hat_grad(dyc - oy)
            gwy = g * wy
            row = fp[..., k + oy:k + oy + h, :]
            inner = torch.zeros_like(field)
            for ix, ox in enumerate(offs):
                val = row[..., k + ox:k + ox + w]
                gp[..., k + oy:k + oy + h, k + ox:k + ox + w] += gwy * wxs[ix]
                inner = inner + val * wxs[ix]
                s_dx = s_dx + val * gwy * wxps[ix]
            s_dy = s_dy + inner * wyp
        g_field = _pad2_T(gp, h, w, k, boundary)
        g_dy = g * s_dy * _clip_grad(disp_y, k)
        g_dx = s_dx * _clip_grad(disp_x, k)
        return g_field, g_dy, g_dx, None, None


def shift_bilinear_sample_2d(
    field: torch.Tensor,
    disp_y: torch.Tensor,
    disp_x: torch.Tensor,
    max_shift: int = 2,
    boundary: str = "clamp",
) -> torch.Tensor:
    """Bilinear sample at ``grid + displacement`` without gathers.

    out[i,j] = bilerp(field, i + disp_y[i,j], j + disp_x[i,j]) assuming
    |disp| <= max_shift (displacement is clipped to that bound).

    Args:
      field: (B, H, W).
      disp_y, disp_x: (B, H, W) displacement in cells.
      max_shift: CFL bound K on |displacement|.
      boundary: 'clamp' or 'periodic'.
    """
    if boundary not in ("clamp", "periodic"):
        raise ValueError(f"unknown sampling boundary {boundary!r}")
    return _ShiftSample.apply(field, disp_y, disp_x, int(max_shift), boundary)
