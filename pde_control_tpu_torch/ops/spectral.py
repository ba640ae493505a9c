"""Spectral Poisson solves in 2D — the exact pressure solve on obstacle-free
domains, and the preconditioner of the CG solves elsewhere.

Counterpart of the 2D part of `pde_control_tpu/ops/spectral.py`. The
cell-centered Neumann (closed-wall) Laplacian is diagonal in the DCT-II
basis and the Dirichlet (open-wall) one in the DST-I basis, so each solve is
one forward and one inverse transform, written as fp32 matrix products
against the orthonormal basis matrices (X = Q_h · x · Q_wᵀ).

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

    b: (B, H, W), assumed zero-mean (compatible); returns the zero-mean p.
    """
    h, w = b.shape[-2], b.shape[-1]
    inv_lam = _on_device(_inv_neumann_eigenvalues, (h, w, float(dx)), b.device)
    return idct2_2d(dct2_2d(b) * inv_lam)


def spectral_dirichlet_solve(b: torch.Tensor, dx: float = 1.0) -> torch.Tensor:
    """Exact solve of A p = b, A = −∇² with Dirichlet (open-wall, ghost
    p = 0) BC — the open-domain pressure operator. b: (B, H, W)."""
    h, w = b.shape[-2], b.shape[-1]
    inv_lam = _on_device(_inv_dirichlet_eigenvalues, (h, w, float(dx)),
                         b.device)
    return dst1_2d(dst1_2d(b) * inv_lam)
