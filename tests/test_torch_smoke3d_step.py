"""The 3D step with the plate (CG, every input's gradient) and without an
obstacle (spectral), and one `optimize_forces` iteration on the 3D PDE,
against the JAX package (`tests/test_torch_smoke3d.py`'s inputs and
tolerances). In a file of their own, of at most five tests, because
their JAX compiles are the slowest of that file's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu import grids3d as jgrids
from pde_control_tpu.control.adjoint import optimize_forces as joptimize
from pde_control_tpu.physics import fluid3d as jfluid
from pde_control_tpu_torch import grids3d
from pde_control_tpu_torch.control.adjoint import optimize_forces
from pde_control_tpu_torch.physics import fluid3d

from test_torch_smoke3d import (
    B,
    D,
    _STEP_CFG,
    _batch,
    _close,
    _domains,
    _pdes,
    _t,
    _vel,
)


@pytest.mark.parametrize("obstacle", [False, True])


def test_step_matches_jax(obstacle):
    """fluid3d_step with a force, inflow, viscosity and the warm start:
    every output and, with the plate, the gradient of each input."""
    jd, td = _domains(obstacle, True)
    rng = np.random.default_rng(6)
    vel = _vel(rng, 0.4)
    rho = rng.uniform(0, 1, size=(B, D, D, D)).astype(np.float32)
    inflow = rng.uniform(0, 0.1, size=rho.shape).astype(np.float32)
    p0 = rng.normal(size=rho.shape).astype(np.float32)
    force = _vel(rng, 0.05)
    inputs = vel + [rho] + force
    cfg = dict(_STEP_CFG, viscosity=0.1)

    def jstep(vz, vy, vx, rho, fz, fy, fx):
        s = jfluid.FluidState3D(jgrids.Staggered3D(vz, vy, vx), rho,
                                inflow=jnp.asarray(inflow),
                                pressure=jnp.asarray(p0))
        out = jfluid.fluid3d_step(s, jd, jfluid.Fluid3DConfig(**cfg),
                                  force=jgrids.Staggered3D(fz, fy, fx))
        v = out.velocity
        return v.vz, v.vy, v.vx, out.density, out.pressure

    if obstacle:
        jouts, vjp = jax.vjp(jax.jit(jstep), *map(jnp.asarray, inputs))
        cots = [rng.normal(size=np.shape(o)).astype(np.float32) for o in jouts]
        cots[-1] *= 0.0  # the warm-start pressure is detached in both packages
        jgrads = vjp(tuple(map(jnp.asarray, cots)))
    else:
        jouts = jax.jit(jstep)(*map(jnp.asarray, inputs))

    args = [_t(a).requires_grad_(True) for a in inputs]
    s = fluid3d.FluidState3D(grids3d.Staggered3D(*args[:3]), args[3],
                             inflow=_t(inflow), pressure=_t(p0))
    out = fluid3d.fluid3d_step(s, td, fluid3d.Fluid3DConfig(**cfg),
                               force=grids3d.Staggered3D(*args[4:]))
    v = out.velocity
    outs = (v.vz, v.vy, v.vx, out.density, out.pressure)
    for name, got, want in zip(("vz", "vy", "vx", "rho", "p"), outs, jouts):
        _close(got, want, 1e-5, name)
    assert out.inflow is s.inflow
    if not obstacle:
        return
    torch.autograd.backward(outs[:4], [_t(c) for c in cots[:4]])
    for name, a, g in zip(("vz", "vy", "vx", "rho", "fz", "fy", "fx"), args,
                          jgrads):
        _close(a.grad, g, 1e-4, name)


def test_optimize_forces_on_the_3d_pde_matches_jax():
    """One optimizer step of the adjoint on the direct 3D PDE, n=2."""
    n, it = 2, 1
    jpde, tpde = _pdes("direct")
    batch = _batch(n, 12, False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jf, jh = joptimize(jpde, jpde.initial_state(jb), jb["obs"][:, n], n=n,
                       iterations=it, learning_rate=0.1, force_reg=1e-4)
    tb = {k: _t(v) for k, v in batch.items()}
    f, h = optimize_forces(tpde, tpde.initial_state(tb), tb["obs"][:, n], n=n,
                           iterations=it, learning_rate=0.1, force_reg=1e-4)
    for k in ("total", "obs_loss", "force_cost"):
        np.testing.assert_allclose(h[k], np.asarray(jh[k]), rtol=1e-4,
                                   err_msg=k)
    assert isinstance(f, grids3d.Staggered3D) and f.vz.shape == (n, B, D + 1, D, D)
    for k in ("vz", "vy", "vx"):
        np.testing.assert_allclose(getattr(f, k).numpy(),
                                   np.asarray(getattr(jf, k)), atol=5e-5)
    assert float(f.vz.abs().max()) > 0
