"""Differentiable pressure-Poisson solve with `custom_linear_solve` semantics.

Counterpart of `pde_control_tpu/physics/poisson.py`. The SPD operator
solved is  A p = −div(acc·grad p)  on fluid cells and identity on solid
cells. On a closed domain A is singular with a constant nullspace on the
fluid; the rhs, the iterates and the preconditioned residual are projected
to zero fluid mean.

`solve_pressure` is a `torch.autograd.Function`: since A is symmetric, the
backward pass is one more solve of the same system with the incoming
gradient as rhs. That solve starts cold, and the projection stays inside it
in both directions (the gradient generally carries a nullspace component;
without the projection CG's first step explodes).
"""

from __future__ import annotations

import torch

from pde_control_tpu_torch.grids import Domain2D
from pde_control_tpu_torch.ops import cuda_cg
from pde_control_tpu_torch.ops.spectral import (
    spectral_dirichlet_solve,
    spectral_neumann_solve,
)

BACKENDS = ("auto", "cuda", "pcg", "jax", "spectral")


def masked_laplace_spd(p: torch.Tensor, domain: Domain2D) -> torch.Tensor:
    """A p = −div(acc·grad p) on fluid cells; p on solid cells. (B, H, W)."""
    lap = domain.pressure_gradient(p).divergence(domain.dx)
    return torch.where(domain.fluid_mask > 0, -lap, p)


def _spatial_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-batch-element inner product over spatial axes, keepdims (B,1,1)."""
    return torch.sum(a * b, dim=tuple(range(1, a.ndim)), keepdim=True)


def cg(matvec, b: torch.Tensor, tol: float, maxiter: int, x0=None,
       precond=None, return_iters: bool = False):
    """Batched (preconditioned) conjugate gradients on an SPD matvec.

    Each batch element runs its own CG (per-element α/β via spatial dots)
    and freezes (α=β=0) once its relative residual is below `tol`, or once
    its residual grows ≥4× above the best seen (fp32 breakdown on singular
    systems); the best iterate is returned. The loop checks on the host
    whether any element is still active, once per iteration.
    """
    apply_m = precond if precond is not None else (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = apply_m(r)
    d = z
    rz = _spatial_dot(r, z)
    rs = _spatial_dot(r, r)
    b2 = torch.clamp(_spatial_dot(b, b), min=1e-30)
    tol2 = tol * tol
    x_best, rs_best = x, rs
    k = 0
    while k < maxiter:
        act = (rs / b2 > tol2) & (rs < 4.0 * rs_best)
        if not bool(act.any()):
            break
        ad = matvec(d)
        dad = _spatial_dot(d, ad)
        ok = act & (dad > 0)
        alpha = torch.where(ok, rz / torch.where(dad > 0, dad, 1.0), 0.0)
        x = x + alpha * d
        r = r - alpha * ad
        z = apply_m(r)
        rz_new = _spatial_dot(r, z)
        rs_new = _spatial_dot(r, r)
        beta = torch.where(ok, rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
        d = z + beta * d
        x_best = torch.where(rs_new < rs_best, x, x_best)
        rs_best = torch.minimum(rs_new, rs_best)
        rz, rs = rz_new, rs_new
        k += 1
    if return_iters:
        return x_best, k
    return x_best


def _projector(domain: Domain2D):
    """p ↦ p minus its fluid mean on fluid cells (closed domains)."""
    fluid = domain.fluid_mask
    is_fluid = fluid > 0
    n_fluid = torch.clamp(fluid.sum(), min=1.0)

    def project(p):
        mean = _spatial_dot(p, fluid) / n_fluid
        return torch.where(is_fluid, p - mean, p)

    return project


def measure_pressure_iterations(
    div: torch.Tensor,
    domain: Domain2D,
    tol: float = 1e-5,
    maxiter: int = 500,
    x0: torch.Tensor | None = None,
    precondition: bool = True,
):
    """Diagnostic: solve the closed-domain pressure system with the batched
    deflated-spectral PCG and return (p, iterations), the largest trip
    count in the batch. x0 reproduces the warm start; x0=None measures the
    cold (backward) solve. The kernel reports per-sample trip counts
    itself (`ops.cuda_cg.pressure_solve`)."""
    if not domain.closed:
        raise ValueError("diagnostic implemented for closed domains "
                         "(every benchmark fluid task)")
    project = _projector(domain)

    def matvec(p):
        return project(masked_laplace_spd(project(p), domain))

    precond = None
    if precondition:
        def precond(r):
            return project(spectral_neumann_solve(project(r), dx=domain.dx))

    b = project(torch.where(domain.fluid_mask > 0, -div, 0.0))
    x0 = None if x0 is None else project(x0)
    with torch.no_grad():
        return cg(matvec, b, tol=tol, maxiter=maxiter, x0=x0, precond=precond,
                  return_iters=True)


def _pick_backend(backend: str, div: torch.Tensor, domain: Domain2D,
                  on_cuda: bool | None = None) -> str:
    """Resolve 'auto', as the JAX package does: the exact spectral solve on
    obstacle-free domains; with obstacles, the kernel where the field is
    on the card (`on_cuda`, by default `div.is_cuda`) and the grid fits
    its shared memory (`cuda_cg.cuda_solve_fits`), and otherwise the
    spectral-preconditioned CG (closed) or plain CG (open). An explicit
    'cuda' beyond the fit raises, as the JAX package's 'pallas' does."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown pressure backend {backend!r}; "
                         f"choose from {BACKENDS}")
    if div.dim() != 3:
        raise ValueError(f"2D fields (B, H, W) only, got {tuple(div.shape)}")
    fits = cuda_cg.cuda_solve_fits(*div.shape[1:])
    if backend != "auto":
        if backend == "cuda" and not fits:
            raise ValueError(f"grid {tuple(div.shape)} exceeds the kernel's "
                             "shared memory; use 'auto' or 'pcg'")
        if backend == "spectral" and domain.has_obstacles:
            raise ValueError("'spectral' is exact only for domains without "
                             "obstacles; use 'pcg'")
        return backend
    if not domain.has_obstacles:
        return "spectral"
    if (div.is_cuda if on_cuda is None else on_cuda) and fits:
        return "cuda"
    return "pcg" if domain.closed else "jax"


def _make_solve(chosen: str, domain: Domain2D, tol: float, maxiter: int):
    """solve(rhs, guess) → p for rhs = where(fluid, -div, 0)."""
    dx = domain.dx
    if chosen == "cuda":
        def solve(rhs, guess):
            # The kernel rebuilds b = project(mask(-div)); feeding -rhs makes
            # its b equal rhs (masking and projection are idempotent, and
            # the backward gradient needs the projection anyway).
            p, _ = cuda_cg.pressure_solve(
                (-rhs).contiguous(), domain.acc_y, domain.acc_x,
                domain.fluid_mask, x0=guess, dx=dx, closed=domain.closed,
                tol=tol, maxiter=maxiter)
            return p

        return solve

    if domain.closed:
        project = _projector(domain)

        def matvec(p):
            return project(masked_laplace_spd(project(p), domain))

        if chosen == "spectral":
            return lambda rhs, guess: project(
                spectral_neumann_solve(project(rhs), dx=dx))
        precond = None
        if chosen == "pcg":
            def precond(r):
                # Deflated: P ∘ M⁻¹ ∘ P keeps PCG in the compatible subspace.
                return project(spectral_neumann_solve(project(r), dx=dx))

        return lambda rhs, guess: cg(
            matvec, project(rhs), tol=tol, maxiter=maxiter, precond=precond,
            x0=None if guess is None else project(guess))

    def matvec(p):
        return masked_laplace_spd(p, domain)

    if chosen == "spectral":
        return lambda rhs, guess: spectral_dirichlet_solve(rhs, dx=dx)
    precond = None
    if chosen == "pcg":
        def precond(r):
            return spectral_dirichlet_solve(r, dx=dx)

    return lambda rhs, guess: cg(matvec, rhs, tol=tol, maxiter=maxiter,
                                 x0=guess, precond=precond)


class _PressureSolve(torch.autograd.Function):
    """p = A⁺ where(fluid, −div, 0); backward: one cold solve of the same
    symmetric system on the gradient. Saves only the geometry."""

    @staticmethod
    def forward(ctx, div, x0, fluid, solve):
        ctx.solve = solve
        ctx.save_for_backward(fluid)
        return solve(torch.where(fluid > 0, -div, 0.0), x0)

    @staticmethod
    def backward(ctx, g):
        (fluid,) = ctx.saved_tensors
        g_b = ctx.solve(g.contiguous(), None)
        return torch.where(fluid > 0, -g_b, 0.0), None, None, None


def solve_pressure(
    div: torch.Tensor,
    domain: Domain2D,
    tol: float = 1e-5,
    maxiter: int = 500,
    backend: str = "auto",
    x0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Solve div(acc·grad p) = div_v for p. div: (B, H, W) → p: (B, H, W).

    backend: 'auto' (see `_pick_backend`), 'cuda' (the hand-written kernel
    for CUDA tensors; its plain torch version for CPU tensors), 'pcg'
    (spectrally preconditioned CG), 'jax' (plain CG, the name kept from the
    JAX package) or 'spectral' (exact; obstacle-free domains only).

    x0 optionally warm-starts the iterative paths (the previous step's
    pressure). It is detached, and the backward solve starts cold: a
    gradient's scale is unrelated to the primal pressure. The spectral path
    ignores x0.
    """
    chosen = _pick_backend(backend, div, domain)
    x0 = None if (x0 is None or chosen == "spectral") else x0.detach()
    solve = _make_solve(chosen, domain, tol, maxiter)
    return _PressureSolve.apply(div, x0, domain.fluid_mask, solve)
