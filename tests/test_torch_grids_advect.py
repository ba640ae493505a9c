"""The port's grids, stencils and shift advection against the JAX package.

Inputs come from a numpy seed and go through both packages; forward values
agree to fp32 rounding (atol 1e-6) and the advection VJP, whose tie-point
subgradients the port writes out by hand, to atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu import grids as jgrids
from pde_control_tpu.ops import interp as jinterp
from pde_control_tpu.ops import stencils as jstencils
from pde_control_tpu.physics import advect as jadvect
from pde_control_tpu_torch import grids as tgrids
from pde_control_tpu_torch.ops import interp as tinterp
from pde_control_tpu_torch.ops import stencils as tstencils
from pde_control_tpu_torch.physics import advect as tadvect
from pde_control_tpu_torch.physics import fluid as tfluid

torch.set_num_threads(1)

H, W = 12, 10


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(t, j, atol=1e-6):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("boundary", ["periodic", "neumann", "dirichlet"])
def test_laplace(rng, boundary):
    u = rng.normal(size=(2, H, W)).astype(np.float32)
    _close(tstencils.laplace(_t(u), 0.5, boundary),
           jstencils.laplace(jnp.asarray(u), 0.5, boundary))


@pytest.mark.parametrize("boundary", ["clamp", "periodic"])
def test_centered_to_faces(rng, boundary):
    c = rng.normal(size=(2, H, W)).astype(np.float32)
    _close(tgrids.centered_to_y_faces(_t(c), boundary),
           jgrids.centered_to_y_faces(jnp.asarray(c), boundary))
    _close(tgrids.centered_to_x_faces(_t(c), boundary),
           jgrids.centered_to_x_faces(jnp.asarray(c), boundary))


def test_staggered_centers_divergence(rng):
    vy = rng.normal(size=(2, H + 1, W)).astype(np.float32)
    vx = rng.normal(size=(2, H, W + 1)).astype(np.float32)
    tv = tgrids.Staggered2D(_t(vy), _t(vx))
    jv = jgrids.Staggered2D(jnp.asarray(vy), jnp.asarray(vx))
    for a, b in zip(tv.at_centers(), jv.at_centers()):
        _close(a, b)
    _close(tv.divergence(0.5), jv.divergence(0.5))
    s = (tv + tv * 2.0 - 0.5 * tv)
    _close(s.vy, (jv + jv * 2.0 - 0.5 * jv).vy)
    assert tv.grid_shape == (H, W) and tv.batch == 2


def _obstacle():
    m = np.zeros((H, W), np.float32)
    m[H // 2, W // 4:W // 2] = 1.0
    m[2:4, 6:8] = 1.0
    return m


@pytest.mark.parametrize("closed", [True, False])
@pytest.mark.parametrize("obstacle", [False, True])
def test_domain_masks_and_pressure_gradient(rng, closed, obstacle):
    m = _obstacle() if obstacle else None
    td = tgrids.Domain2D.create(H, W, obstacle_mask=m, dx=0.5, closed=closed,
                                device="cpu")
    jd = jgrids.Domain2D.create(H, W, obstacle_mask=None if m is None
                                else jnp.asarray(m), dx=0.5, closed=closed)
    assert td.has_obstacles == jd.has_obstacles
    for name in ("fluid_mask", "acc_y", "acc_x"):
        _close(getattr(td, name), getattr(jd, name), atol=0)
    p = rng.normal(size=(2, H, W)).astype(np.float32)
    tg, jg = td.pressure_gradient(_t(p)), jd.pressure_gradient(jnp.asarray(p))
    _close(tg.vy, jg.vy)
    _close(tg.vx, jg.vx)
    vy = rng.normal(size=(2, H + 1, W)).astype(np.float32)
    vx = rng.normal(size=(2, H, W + 1)).astype(np.float32)
    tm = td.mask_velocity(tgrids.Staggered2D(_t(vy), _t(vx)))
    jm = jd.mask_velocity(jgrids.Staggered2D(jnp.asarray(vy), jnp.asarray(vx)))
    _close(tm.vy, jm.vy, atol=0)
    _close(tm.vx, jm.vx, atol=0)


def _displacements(rng, shape, k):
    """Random displacements with every tie point planted: 0, ±0.5, ±1,
    ±k, and beyond ±k (clipped)."""
    d = rng.uniform(-k - 0.7, k + 0.7, size=shape).astype(np.float32)
    ties = np.array([0.0, 1.0, -1.0, 0.5, -0.5, k, -k, k + 0.5, -k - 1.0,
                     2.0, -2.0], np.float32)
    flat = d.reshape(-1)
    idx = rng.choice(flat.size, size=flat.size // 2, replace=False)
    flat[idx] = rng.choice(ties, size=idx.size)
    return d


def _vjp_pair(tfn, jfn, args, rng):
    """Forward values and VJP of the torch and JAX versions on `args`."""
    targs = [_t(a).requires_grad_(True) for a in args]
    tout = tfn(*targs)
    g = rng.normal(size=tuple(tout.shape)).astype(np.float32)
    tout.backward(_t(g))
    jout, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    jgrads = vjp(jnp.asarray(g))
    return tout, jout, [a.grad for a in targs], jgrads


@pytest.mark.parametrize("boundary", ["clamp", "periodic"])
@pytest.mark.parametrize("k", [1, 2])
def test_shift_sample_forward_and_vjp(rng, boundary, k):
    f = rng.normal(size=(2, H, W)).astype(np.float32)
    dy = _displacements(rng, f.shape, k)
    dx = _displacements(rng, f.shape, k)
    tout, jout, tg, jg = _vjp_pair(
        lambda a, b, c: tinterp.shift_bilinear_sample_2d(a, b, c, k, boundary),
        lambda a, b, c: jinterp.shift_bilinear_sample_2d(a, b, c, k, boundary),
        [f, dy, dx], rng)
    _close(tout, jout)
    for a, b in zip(tg, jg):
        _close(a, b, atol=1e-5)


def test_shift_sample_zero_displacement_vjp(rng):
    """The main path's first step: every displacement is exactly 0, where
    autograd's subgradient of |d| (0) differs from JAX's (+1)."""
    f = rng.normal(size=(1, H, W)).astype(np.float32)
    z = np.zeros_like(f)
    tout, jout, tg, jg = _vjp_pair(
        lambda a, b, c: tinterp.shift_bilinear_sample_2d(a, b, c, 2),
        lambda a, b, c: jinterp.shift_bilinear_sample_2d(a, b, c, 2),
        [f, z, z], rng)
    _close(tout, f)
    for a, b in zip(tg, jg):
        _close(a, b, atol=1e-5)
    assert np.abs(np.asarray(jg[1])).max() > 0.1  # the tie gradient is live


@pytest.mark.parametrize("scale", [0.0, 0.6, 3.0])
def test_advect_centered_and_staggered(rng, scale):
    vy = (scale * rng.normal(size=(2, H + 1, W))).astype(np.float32)
    vx = (scale * rng.normal(size=(2, H, W + 1))).astype(np.float32)
    c = rng.normal(size=(2, H, W)).astype(np.float32)

    def t_fn(c, vy, vx):
        v = tgrids.Staggered2D(vy, vx)
        out = tadvect.advect_staggered(v, 1.0, 0.5)
        return torch.cat([tadvect.advect_centered(c, v, 1.0, 0.5).reshape(-1),
                          out.vy.reshape(-1), out.vx.reshape(-1)])

    def j_fn(c, vy, vx):
        v = jgrids.Staggered2D(vy, vx)
        out = jadvect.advect_staggered(v, 1.0, 0.5)
        return jnp.concatenate([jadvect.advect_centered(c, v, 1.0, 0.5).reshape(-1),
                                out.vy.reshape(-1), out.vx.reshape(-1)])

    tout, jout, tg, jg = _vjp_pair(t_fn, j_fn, [c, vy, vx], rng)
    _close(tout, jout)
    for a, b in zip(tg, jg):
        _close(a, b, atol=1e-5)


def test_advect_rejects_unported_mode():
    """Both of the JAX package's modes are ported ('gather' is held to it in
    `tests/test_torch_gather.py`); a mode neither package has raises."""
    v = tgrids.Staggered2D.zeros(1, H, W, device="cpu")
    with pytest.raises(ValueError, match="unknown advection mode"):
        tadvect.advect_centered(torch.zeros(1, H, W), v, 1.0, mode="spline")
    with pytest.raises(ValueError, match="unknown advection mode"):
        tadvect.advect_staggered(v, 1.0, mode="spline")


def test_constructors_default_to_the_gpu():
    """With no `device`, the port builds on the card; on a host without one
    it raises and says how to ask for the CPU, and never falls back."""
    if torch.cuda.is_available():
        assert tgrids.Domain2D.create(H, W).device.type == "cuda"
        return
    for build in (lambda: tgrids.Domain2D.create(H, W),
                  lambda: tgrids.Staggered2D.zeros(1, H, W),
                  lambda: tfluid.FluidState.zeros(1, H, W)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    d = tgrids.Domain2D.create(H, W, device="cpu")
    assert d.device.type == "cpu" and d.fluid_mask.shape == (H, W)
