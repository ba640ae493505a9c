"""Spectral Poisson solves in 2D and 3D — the exact pressure solve on
obstacle-free domains, and the preconditioner of the CG solves elsewhere.

Counterpart of `pde_control_tpu/ops/spectral.py`. The cell-centered
Neumann (closed-wall) Laplacian is diagonal in the DCT-II basis and the
Dirichlet (open-wall) one in the DST-I basis, so each solve is one forward
and one inverse transform, written as fp32 matrix products against the
orthonormal basis matrices (X = Q_h · x · Q_wᵀ; in 3D one product per
axis, depth, then height, then width). The 2D solves dispatch to the 3D
ones on a (B, D, H, W) field, as the JAX package's do.

The solve divides by eigenvalues down to (π/N)², so these products must run
in full fp32: with TF32 (`torch.backends.cuda.matmul.allow_tf32`) the
rounding of the inputs is amplified into O(1) solution error. This package
never turns TF32 on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis Q, rows = frequencies: Q @ Q.T = I."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    q = np.cos(np.pi * k * (2 * i + 1) / (2 * n))
    q[0] *= np.sqrt(1.0 / n)
    q[1:] *= np.sqrt(2.0 / n)
    return q.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _dst_matrix(n: int) -> np.ndarray:
    """Orthonormal DST-I basis: Q[k,i] = √(2/(N+1))·sin(π(k+1)(i+1)/(N+1)).
    Symmetric and involutory (Q = Qᵀ = Q⁻¹)."""
    k = np.arange(1, n + 1)[:, None]
    i = np.arange(1, n + 1)[None, :]
    q = np.sqrt(2.0 / (n + 1)) * np.sin(np.pi * k * i / (n + 1))
    return q.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _inv_neumann_eigenvalues(h: int, w: int, dx: float) -> np.ndarray:
    """1/eigenvalues of A = −∇²_neumann/dx² in the DCT-II basis, (H, W);
    the (0,0) nullspace mode maps to 0 (pseudo-inverse)."""
    ky = 2.0 - 2.0 * np.cos(np.pi * np.arange(h) / h)
    kx = 2.0 - 2.0 * np.cos(np.pi * np.arange(w) / w)
    lam = (ky[:, None] + kx[None, :]) / (dx * dx)
    lam[0, 0] = np.inf  # constant nullspace → 1/λ = 0
    return (1.0 / lam).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _inv_dirichlet_eigenvalues(h: int, w: int, dx: float) -> np.ndarray:
    """1/eigenvalues of A = −∇²_dirichlet/dx² (zero ghost cells) in the
    DST-I basis — nonsingular, so a true inverse."""
    ky = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, h + 1) / (h + 1))
    kx = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, w + 1) / (w + 1))
    lam = (ky[:, None] + kx[None, :]) / (dx * dx)
    return (1.0 / lam).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _on_device(fn, args: tuple, device: torch.device) -> torch.Tensor:
    """fn(*args) (one of the cached numpy tables above) as a tensor on
    `device`, copied once per device."""
    return torch.tensor(fn(*args), device=device)


def _transform(x: torch.Tensor, qh: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """qh · x · qwᵀ over the last two axes, in fp32."""
    return torch.matmul(torch.matmul(qh, x), qw.transpose(0, 1))


def dct2_2d(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2D DCT-II over the last two axes (B, H, W) → (B, H, W)."""
    return _transform(x, _on_device(_dct_matrix, (x.shape[-2],), x.device),
                      _on_device(_dct_matrix, (x.shape[-1],), x.device))


def idct2_2d(x: torch.Tensor) -> torch.Tensor:
    """Inverse of `dct2_2d` (transpose of the orthonormal transform)."""
    qh = _on_device(_dct_matrix, (x.shape[-2],), x.device).transpose(0, 1)
    qw = _on_device(_dct_matrix, (x.shape[-1],), x.device).transpose(0, 1)
    return _transform(x, qh, qw)


def dst1_2d(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2D DST-I over the last two axes (involutory)."""
    return _transform(x, _on_device(_dst_matrix, (x.shape[-2],), x.device),
                      _on_device(_dst_matrix, (x.shape[-1],), x.device))


def spectral_neumann_solve(b: torch.Tensor, dx: float = 1.0) -> torch.Tensor:
    """Exact (pseudo-inverse) solve of A p = b, A = −∇² with Neumann BC.

    b: (B, H, W) or (B, D, H, W) (dispatches to the 3D solve), assumed
    zero-mean (compatible); returns the zero-mean p.
    """
    if b.dim() == 4:
        return spectral_neumann_solve_3d(b, dx)
    h, w = b.shape[-2], b.shape[-1]
    inv_lam = _on_device(_inv_neumann_eigenvalues, (h, w, float(dx)), b.device)
    return idct2_2d(dct2_2d(b) * inv_lam)


def spectral_dirichlet_solve(b: torch.Tensor, dx: float = 1.0) -> torch.Tensor:
    """Exact solve of A p = b, A = −∇² with Dirichlet (open-wall, ghost
    p = 0) BC — the open-domain pressure operator. b: (B, H, W) or
    (B, D, H, W) (dispatches to the 3D solve)."""
    if b.dim() == 4:
        return spectral_dirichlet_solve_3d(b, dx)
    h, w = b.shape[-2], b.shape[-1]
    inv_lam = _on_device(_inv_dirichlet_eigenvalues, (h, w, float(dx)),
                         b.device)
    return dst1_2d(dst1_2d(b) * inv_lam)


# ---------------------------------------------------------------- 3D solves
# Volumes b: (B, D, H, W). The separable eigenstructure extends directly:
# three basis products per transform.


def _apply_axes_3d(x: torch.Tensor, qd: torch.Tensor, qh: torch.Tensor,
                   qw: torch.Tensor) -> torch.Tensor:
    """qd, qh, qw applied along depth, height and width in that order, in
    fp32 (the JAX package's three einsums)."""
    x = torch.einsum("kd,bdhw->bkhw", qd, x)
    x = torch.einsum("lh,bkhw->bklw", qh, x)
    return torch.einsum("mw,bklw->bklm", qw, x)


def _bases(fn, x: torch.Tensor) -> list[torch.Tensor]:
    return [_on_device(fn, (n,), x.device) for n in x.shape[-3:]]


def dct2_3d(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal 3D DCT-II over the last three axes."""
    return _apply_axes_3d(x, *_bases(_dct_matrix, x))


def idct2_3d(x: torch.Tensor) -> torch.Tensor:
    """Inverse of `dct2_3d` (transpose of the orthonormal transform)."""
    return _apply_axes_3d(x, *(q.transpose(0, 1)
                               for q in _bases(_dct_matrix, x)))


def dst1_3d(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal 3D DST-I over the last three axes (involutory)."""
    return _apply_axes_3d(x, *_bases(_dst_matrix, x))


@functools.lru_cache(maxsize=32)
def _inv_neumann_eigenvalues_3d(d: int, h: int, w: int,
                                dx: float) -> np.ndarray:
    """1/eigenvalues of the 3D Neumann operator in the DCT-II basis,
    (D, H, W); the constant nullspace mode maps to 0."""
    kz, ky, kx = (2.0 - 2.0 * np.cos(np.pi * np.arange(n) / n)
                  for n in (d, h, w))
    lam = (kz[:, None, None] + ky[None, :, None] + kx[None, None, :]) / (
        dx * dx)
    lam[0, 0, 0] = np.inf  # constant nullspace → 1/λ = 0
    return (1.0 / lam).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _inv_dirichlet_eigenvalues_3d(d: int, h: int, w: int,
                                  dx: float) -> np.ndarray:
    """1/eigenvalues of the 3D Dirichlet operator in the DST-I basis."""
    kz, ky, kx = (2.0 - 2.0 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1))
                  for n in (d, h, w))
    lam = (kz[:, None, None] + ky[None, :, None] + kx[None, None, :]) / (
        dx * dx)
    return (1.0 / lam).astype(np.float32)


def spectral_neumann_solve_3d(b: torch.Tensor, dx: float = 1.0) -> torch.Tensor:
    """The 3D Neumann solve: b (B, D, H, W), zero-mean."""
    inv_lam = _on_device(_inv_neumann_eigenvalues_3d,
                         (*b.shape[-3:], float(dx)), b.device)
    return idct2_3d(dct2_3d(b) * inv_lam)


def spectral_dirichlet_solve_3d(b: torch.Tensor,
                                dx: float = 1.0) -> torch.Tensor:
    """The 3D Dirichlet solve: b (B, D, H, W)."""
    inv_lam = _on_device(_inv_dirichlet_eigenvalues_3d,
                         (*b.shape[-3:], float(dx)), b.device)
    return dst1_3d(dst1_3d(b) * inv_lam)
