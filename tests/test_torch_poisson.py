"""The port's pressure solve against the JAX package.

The kernel's plain version (`cuda_cg.pcg_plain`, a transcription of the
TPU kernel's `pcg_core`) is held against JAX's spectral-preconditioned CG
('pcg') and against the Pallas kernel itself in interpret mode at 16², as
tests/test_pallas.py runs it. Tolerances: solution atol 5e-3 at tol 1e-7
(the bar of test_pallas.py), residual atol 5e-4, VJP rtol 1e-3 / atol 1e-4,
trip counts within 1 of `measure_pressure_iterations`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.physics import poisson as jpoisson
from pde_control_tpu_torch.grids import Domain2D as TDomain
from pde_control_tpu_torch.ops import cuda_cg
from pde_control_tpu_torch.physics import poisson as tpoisson

torch.set_num_threads(1)

N = 16
CASES = {"closed_obstacle": (True, True), "closed_free": (False, True),
         "open_free": (False, False), "open_obstacle": (True, False)}


def _domains(obstacle: bool, closed: bool, n: int = N):
    m = None
    if obstacle:
        m = np.zeros((n, n), np.float32)
        m[5:9, 6:11] = 1.0
        m[n // 2 + 3, n // 4:n // 2] = 1.0
    return (TDomain.create(n, n, obstacle_mask=m, closed=closed, device="cpu"),
            JDomain.create(n, n, obstacle_mask=None if m is None
                           else jnp.asarray(m), closed=closed))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _plain(div, td, x0=None, tol=1e-7, maxiter=800):
    return cuda_cg.pressure_solve(
        _t(div), td.acc_y, td.acc_x, td.fluid_mask,
        x0=None if x0 is None else _t(x0), dx=td.dx, closed=td.closed,
        tol=tol, maxiter=maxiter)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ref", ["pcg", "pallas"])
def test_plain_pcg_matches_jax(rng, case, warm, ref):
    td, jd = _domains(*CASES[case])
    div = rng.normal(size=(2, N, N)).astype(np.float32)
    x0 = rng.normal(size=(2, N, N)).astype(np.float32) if warm else None
    p_t, iters = _plain(div, td, x0)
    p_j = jpoisson.solve_pressure(jnp.asarray(div), jd, tol=1e-7, maxiter=800,
                                  backend=ref,
                                  x0=None if x0 is None else jnp.asarray(x0))
    r_t = np.asarray(jpoisson.masked_laplace_spd(jnp.asarray(p_t.numpy()), jd))
    r_j = np.asarray(jpoisson.masked_laplace_spd(p_j, jd))
    np.testing.assert_allclose(r_t, r_j, atol=5e-4)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=5e-3)
    assert iters.dtype == torch.int32 and iters.shape == (2,)
    assert int(iters.min()) > 0


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("precond", [True, False])
def test_plain_pcg_trip_counts(rng, warm, precond):
    td, jd = _domains(True, True)
    div = rng.normal(size=(3, N, N)).astype(np.float32)
    x0 = None
    if warm:
        x0 = np.asarray(jpoisson.solve_pressure(jnp.asarray(div), jd, tol=1e-3))
        div = div + 0.05 * rng.normal(size=div.shape).astype(np.float32)
    _, iters = cuda_cg.pressure_solve(
        _t(div), td.acc_y, td.acc_x, td.fluid_mask,
        x0=None if x0 is None else _t(x0), tol=1e-5, maxiter=500,
        precond=precond)
    _, k_j = jpoisson.measure_pressure_iterations(
        jnp.asarray(div), jd, tol=1e-5, maxiter=500,
        x0=None if x0 is None else jnp.asarray(x0), precondition=precond)
    _, k_t = tpoisson.measure_pressure_iterations(
        _t(div), td, tol=1e-5, maxiter=500,
        x0=None if x0 is None else _t(x0), precondition=precond)
    assert abs(int(iters.max()) - int(k_j)) <= 1
    assert abs(k_t - int(k_j)) <= 1


@pytest.mark.parametrize("backend", ["auto", "cuda", "pcg", "jax", "spectral"])
@pytest.mark.parametrize("case", list(CASES))
def test_solve_pressure_forward_and_vjp(rng, case, backend):
    obstacle, closed = CASES[case]
    td, jd = _domains(obstacle, closed)
    div = rng.normal(size=(2, N, N)).astype(np.float32)
    if backend == "spectral" and obstacle:
        # Exact only without obstacles: both packages refuse.
        with pytest.raises(ValueError, match="obstacles"):
            jpoisson.solve_pressure(jnp.asarray(div), jd, backend=backend)
        with pytest.raises(ValueError, match="obstacles"):
            tpoisson.solve_pressure(_t(div), td, backend=backend)
        return
    x0 = rng.normal(size=(2, N, N)).astype(np.float32)
    wgt = rng.normal(size=(2, N, N)).astype(np.float32)
    # The JAX package's names: its kernel is 'pallas' (interpret mode here).
    jbackend = {"cuda": "pallas"}.get(backend, backend)
    tol, maxiter = 1e-7, 800

    def jloss(d):
        p = jpoisson.solve_pressure(d, jd, tol=tol, maxiter=maxiter,
                                    backend=jbackend, x0=jnp.asarray(x0))
        return jnp.sum(p * wgt), p

    (_, p_j), g_j = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(div))
    d_t = _t(div).requires_grad_(True)
    p_t = tpoisson.solve_pressure(d_t, td, tol=tol, maxiter=maxiter,
                                  backend=backend, x0=_t(x0))
    (p_t * _t(wgt)).sum().backward()
    np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j), atol=5e-3)
    np.testing.assert_allclose(d_t.grad.numpy(), np.asarray(g_j), rtol=1e-3,
                               atol=1e-4)


def test_pick_backend():
    td, _ = _domains(True, True)
    free, _ = _domains(False, False)
    div = torch.zeros(1, N, N)
    assert tpoisson._pick_backend("auto", div, td) == "pcg"
    assert tpoisson._pick_backend("auto", div, free) == "spectral"
    assert tpoisson._pick_backend("auto", div, _domains(True, False)[0]) == "jax"
    assert tpoisson._pick_backend("cuda", div, td) == "cuda"
    with pytest.raises(ValueError, match="obstacles"):
        tpoisson._pick_backend("spectral", div, td)
    with pytest.raises(ValueError, match="unknown pressure backend"):
        tpoisson._pick_backend("pallas", div, td)
    # 'auto' on the card, as the JAX package routes on a TPU: the kernel
    # where the grid fits its shared memory (every grid the Pallas gate
    # admits: 160² and 256² among them), else the plain CG of the domain's
    # kind (8×8192 fits no plan); a CPU field never reaches it.
    big = np.zeros((8, 8192), np.float32)
    big[4, 2048:4096] = 1.0
    for closed, fallback in ((True, "pcg"), (False, "jax")):
        small = _domains(True, closed)[0]
        large = TDomain.create(8, 8192, obstacle_mask=big, closed=closed,
                               device="cpu")
        div_large = torch.zeros(1, 8, 8192)
        assert tpoisson._pick_backend("auto", div, small, on_cuda=True) == "cuda"
        assert tpoisson._pick_backend("auto", div_large, large,
                                      on_cuda=True) == fallback
        assert tpoisson._pick_backend("auto", div, small, on_cuda=False) == fallback
        assert tpoisson._pick_backend("auto", div_large, large) == fallback
        with pytest.raises(ValueError, match="shared memory"):
            tpoisson._pick_backend("cuda", div_large, large)
        for n in (160, 256):
            edge = np.zeros((n, n), np.float32)
            edge[n // 2, n // 4:n // 2] = 1.0
            at_edge = TDomain.create(n, n, obstacle_mask=edge, closed=closed,
                                     device="cpu")
            assert tpoisson._pick_backend("auto", torch.zeros(1, n, n), at_edge,
                                          on_cuda=True) == "cuda"
            assert tpoisson._pick_backend("cuda", torch.zeros(1, n, n),
                                          at_edge) == "cuda"
    free_large = TDomain.create(160, 160, device="cpu")
    assert tpoisson._pick_backend("auto", torch.zeros(1, 160, 160), free_large,
                                  on_cuda=True) == "spectral"
