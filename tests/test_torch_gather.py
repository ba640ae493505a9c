"""Gather-mode advection (`advection_mode='gather'`) against the JAX
package, on the CPU.

* `ops/interp.py :: bilinear_sample_2d` for both boundaries, at
  coordinates inside the grid, out of range on either side and on exact
  integers (floor's tie: the named cell is the lower corner): forward at
  atol 1e-6, the VJP with respect to the field and both coordinates at
  atol 1e-5; `Staggered2D.sample_at` likewise.
* `advect_centered` and `advect_staggered` with mode='gather', at
  displacements within and beyond the shift sampler's bound, likewise.
* One `fluid_step` at 16² with the bench plate, `advection_mode='gather'`,
  warm-started pressure at tol 1e-6: the state and the VJP with respect to
  vy, vx, rho and the force at rtol 1e-4 (atol 1e-4 of scale), as
  `tests/test_torch_fluid.py` holds the shift-mode step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu import grids as jgrids
from pde_control_tpu.ops import interp as jinterp
from pde_control_tpu.physics import advect as jadvect
from pde_control_tpu.physics import fluid as jfluid
from pde_control_tpu_torch import grids as tgrids
from pde_control_tpu_torch.ops import interp as tinterp
from pde_control_tpu_torch.physics import advect as tadvect
from pde_control_tpu_torch.physics import fluid as tfluid

torch.set_num_threads(1)

H, W = 12, 10


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=atol)


def _vjp_pair(tfn, jfn, args, rng):
    """Forward values and VJP of the torch and JAX versions on `args`."""
    targs = [_t(a).requires_grad_(True) for a in args]
    tout = tfn(*targs)
    g = rng.normal(size=tuple(tout.shape)).astype(np.float32)
    tout.backward(_t(g))
    jout, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    jgrads = vjp(jnp.asarray(g))
    return tout, jout, [a.grad for a in targs], jgrads


def _check(tfn, jfn, args, rng):
    tout, jout, tg, jg = _vjp_pair(tfn, jfn, args, rng)
    _close(tout, jout, 1e-6)
    for a, b in zip(tg, jg):
        _close(a, b, 1e-5)


def _coords(rng, shape, n):
    """Coordinates over [-3, n + 2]: in range, out of range on both sides,
    and a third of them on exact integers (0, n - 1, n, -1, interior)."""
    c = rng.uniform(-3.0, n + 2.0, size=shape).astype(np.float32)
    flat = c.reshape(-1)
    idx = rng.choice(flat.size, size=flat.size // 3, replace=False)
    flat[idx] = rng.integers(-2, n + 2, size=idx.size).astype(np.float32)
    return c


@pytest.mark.parametrize("boundary", ["clamp", "periodic"])
def test_bilinear_sample_forward_and_vjp(rng, boundary):
    f = rng.normal(size=(2, H, W)).astype(np.float32)
    y = _coords(rng, (2, 7, 5), H)
    x = _coords(rng, (2, 7, 5), W)
    _check(lambda a, b, c: tinterp.bilinear_sample_2d(a, b, c, boundary),
           lambda a, b, c: jinterp.bilinear_sample_2d(a, b, c, boundary),
           [f, y, x], rng)


def test_bilinear_sample_integer_ties(rng):
    """On an exact integer the sample is the cell itself, and the coordinate
    gradient is the forward difference to the next cell (floor's tie)."""
    f = rng.normal(size=(1, H, W)).astype(np.float32)
    iy, ix = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    y, x = iy[None].astype(np.float32), ix[None].astype(np.float32)
    _check(lambda a, b, c: tinterp.bilinear_sample_2d(a, b, c, "clamp"),
           lambda a, b, c: jinterp.bilinear_sample_2d(a, b, c, "clamp"),
           [f, y, x], rng)
    out = tinterp.bilinear_sample_2d(_t(f), _t(y), _t(x))
    np.testing.assert_array_equal(out.numpy(), f)


def test_sample_at(rng):
    vy = rng.normal(size=(2, H + 1, W)).astype(np.float32)
    vx = rng.normal(size=(2, H, W + 1)).astype(np.float32)
    y = _coords(rng, (2, 6), H)
    x = _coords(rng, (2, 6), W)

    def tfn(a, b, c, d):
        return torch.cat(tgrids.Staggered2D(a, b).sample_at(c, d), dim=-1)

    def jfn(a, b, c, d):
        return jnp.concatenate(jgrids.Staggered2D(a, b).sample_at(c, d), -1)

    _check(tfn, jfn, [vy, vx, y, x], rng)


@pytest.mark.parametrize("scale", [0.6, 3.0])
def test_advect_gather_mode(rng, scale):
    vy = (scale * rng.normal(size=(2, H + 1, W))).astype(np.float32)
    vx = (scale * rng.normal(size=(2, H, W + 1))).astype(np.float32)
    c = rng.normal(size=(2, H, W)).astype(np.float32)

    def fn(grids, advect, cat):
        def run(c, vy, vx):
            v = grids.Staggered2D(vy, vx)
            out = advect.advect_staggered(v, 1.0, 0.5, mode="gather")
            return cat([advect.advect_centered(c, v, 1.0, 0.5,
                                               mode="gather").reshape(-1),
                        out.vy.reshape(-1), out.vx.reshape(-1)])
        return run

    _check(fn(tgrids, tadvect, torch.cat), fn(jgrids, jadvect, jnp.concatenate),
           [c, vy, vx], rng)


def test_fluid_step_gather_mode(rng):
    h = 16
    m = np.zeros((h, h), np.float32)
    m[h // 2, h // 4:h // 2] = 1.0
    kw = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-6, pressure_maxiter=500,
              warm_start_pressure=True, advection_mode="gather")
    tcfg, jcfg = tfluid.FluidConfig(**kw), jfluid.FluidConfig(**kw)
    td = tgrids.Domain2D.create(h, h, obstacle_mask=m, device="cpu")
    jd = jgrids.Domain2D.create(h, h, obstacle_mask=jnp.asarray(m))
    args = [(0.8 * rng.normal(size=(2, h + 1, h))).astype(np.float32),
            (0.8 * rng.normal(size=(2, h, h + 1))).astype(np.float32),
            rng.uniform(0, 1, size=(2, h, h)).astype(np.float32),
            (0.02 * rng.normal(size=(2, h + 1, h))).astype(np.float32),
            (0.02 * rng.normal(size=(2, h, h + 1))).astype(np.float32)]

    def step(mod, stag, domain, cfg, zeros, cat):
        def run(vy, vx, rho, fy, fx):
            s = mod.fluid_step(
                mod.FluidState(velocity=stag(vy, vx), density=rho,
                               pressure=zeros(rho)),
                domain, cfg, force=stag(fy, fx))
            return cat([s.velocity.vy.reshape(-1), s.velocity.vx.reshape(-1),
                        s.density.reshape(-1), s.pressure.reshape(-1)])
        return run

    tout, jout, tg, jg = _vjp_pair(
        step(tfluid, tgrids.Staggered2D, td, tcfg, torch.zeros_like, torch.cat),
        step(jfluid, jgrids.Staggered2D, jd, jcfg, jnp.zeros_like,
             jnp.concatenate), args, rng)
    for a, b in [(tout, jout)] + list(zip(tg, jg)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())
