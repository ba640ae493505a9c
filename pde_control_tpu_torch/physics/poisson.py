"""Differentiable pressure-Poisson solve with `custom_linear_solve` semantics.

Counterpart of `pde_control_tpu/physics/poisson.py`. The SPD operator
solved is  A p = −div(acc·grad p)  on fluid cells and identity on solid
cells. On a closed domain A is singular with a constant nullspace on the
fluid; the rhs, the iterates and the preconditioned residual are projected
to zero fluid mean.

The same code solves 3D volumes (B, D, H, W) on a `grids3d.Domain3D`,
which has the surface of `Domain2D` these functions use: the exact
spectral solve without obstacles, the CG with them ('pcg', 'jax'). `cg`
stops once no sample is active when run eagerly, and runs all `maxiter`
trips while a CUDA graph is being captured, with the same result, so a
captured training step holds the solve. The kernel is 2D only, as the
JAX package's Pallas kernel is.

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


def _capturing(t: torch.Tensor) -> bool:
    """Whether `t` is a CUDA tensor and the current stream is being
    captured into a CUDA graph."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def cg(matvec, b: torch.Tensor, tol: float, maxiter: int, x0=None,
       precond=None, return_iters: bool = False):
    """Batched (preconditioned) conjugate gradients on an SPD matvec.

    Each batch element runs its own CG (per-element α/β via spatial dots)
    and freezes (α=β=0) once its relative residual is below `tol`, or once
    its residual grows ≥4× above the best seen (fp32 breakdown on singular
    systems); the best iterate is returned.

    Eager, the loop asks the host once a trip whether any element is still
    active and stops when none is. While the current stream is captured
    into a CUDA graph, where a host read is not allowed, it runs all
    `maxiter` trips: a trip after every element has frozen (α = β = 0)
    leaves x and r, so rs, rs_best and x_best, as they were, and an
    element once frozen stays frozen; so x_best and the trip counts are
    the eager loop's bit for bit. The loop-carried tensors are updated in
    place.

    return_iters: also return each element's trip count, the trips on
    which it was active, an int32 (B,) tensor on b's device (the eager
    loop ran as many trips as the largest of them).
    """
    apply_m = precond if precond is not None else (lambda r: r)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - matvec(x)
    d = apply_m(r).clone()
    rz = _spatial_dot(r, d)
    rs = _spatial_dot(r, r)
    b2 = torch.clamp(_spatial_dot(b, b), min=1e-30)
    tol2 = tol * tol
    x_best, rs_best = x.clone(), rs.clone()
    trips = torch.zeros(rs.shape, dtype=torch.int32, device=b.device)

    def active():
        return (rs / b2 > tol2) & (rs < 4.0 * rs_best)

    def trip(act):
        ad = matvec(d)
        dad = _spatial_dot(d, ad)
        ok = act & (dad > 0)
        alpha = torch.where(ok, rz / torch.where(dad > 0, dad, 1.0), 0.0)
        # A frozen element adds 0·d, which is NaN where d is not finite, as
        # in the JAX package's while_loop while another element is active;
        # x_best never takes a NaN residual's iterate.
        x.add_(alpha * d)
        r.sub_(alpha * ad)
        z = apply_m(r)
        rz_new = _spatial_dot(r, z)
        rs_new = _spatial_dot(r, r)
        beta = torch.where(ok, rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
        d.mul_(beta).add_(z)
        x_best.copy_(torch.where(rs_new < rs_best, x, x_best))
        rs_best.copy_(torch.minimum(rs_new, rs_best))
        rz.copy_(rz_new)
        rs.copy_(rs_new)
        trips.add_(act)

    if _capturing(b):
        for _ in range(maxiter):
            trip(active())
    else:
        for _ in range(maxiter):
            act = active()
            if not bool(act.any()):
                break
            trip(act)
    if return_iters:
        return x_best, trips.reshape(-1)
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
        p, trips = cg(matvec, b, tol=tol, maxiter=maxiter, x0=x0,
                      precond=precond, return_iters=True)
    return p, int(trips.max())


def _pick_backend(backend: str, div: torch.Tensor, domain: Domain2D,
                  on_cuda: bool | None = None) -> str:
    """Resolve 'auto', as the JAX package does: the exact spectral solve on
    obstacle-free domains; with obstacles, the kernel where the field is
    on the card (`on_cuda`, by default `div.is_cuda`) and the grid fits
    its shared memory (`cuda_cg.cuda_solve_fits`: every grid the JAX
    package's Pallas gate admits, 256² among them), and otherwise the
    spectral-preconditioned CG (closed) or plain CG (open). An explicit
    'cuda' beyond the fit raises, as the JAX package's 'pallas' does.
    On a volume (B, D, H, W): the spectral solve without obstacles and
    'pcg' with them, on open and closed domains alike, on the card too
    (under a CUDA graph's capture `cg` runs all `maxiter` trips); 'cuda'
    raises (the kernel is 2D only)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown pressure backend {backend!r}; "
                         f"choose from {BACKENDS}")
    if div.dim() not in (3, 4):
        raise ValueError(f"fields (B, H, W) or (B, D, H, W) only, got "
                         f"{tuple(div.shape)}")
    if backend == "spectral" and domain.has_obstacles:
        raise ValueError("'spectral' is exact only for domains without "
                         "obstacles; use 'pcg'")
    if div.dim() == 4:
        if backend == "cuda":
            raise ValueError("the CUDA pressure kernel takes 2D (B, H, W) "
                             "fields only; use 'auto'/'spectral'/'pcg'/'jax'")
        if backend != "auto":
            return backend
        return "pcg" if domain.has_obstacles else "spectral"
    fits = cuda_cg.cuda_solve_fits(*div.shape[1:])
    if backend != "auto":
        if backend == "cuda" and not fits:
            raise ValueError(f"grid {tuple(div.shape)} exceeds the kernel's "
                             "shared memory; use 'auto' or 'pcg'")
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
    """Solve div(acc·grad p) = div_v for p. div: (B, H, W) → p: (B, H, W),
    or (B, D, H, W) → (B, D, H, W) on a `Domain3D`.

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
