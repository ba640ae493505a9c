"""The fused fluid step (K2 forward, K3 backward) against the JAX package.

On CPU tensors `ops/cuda_fluid.py` runs the kernels' plain versions; here
they are held to `pde_control_tpu/ops/pallas_fluid.py`, whose Pallas
kernels run in interpret mode, as `tests/test_pallas_fluid.py` runs them:
16², batch 2, dt 0.7, tol 1e-6, maxiter 400; forward at atol 5e-6 / rtol
1e-5, the VJP at atol 3e-5 of each gradient's largest entry. The window
adjoint is held to JAX's at displacements planted on the tie points, the
routing of `fluid_step(fused='cuda')` to the JAX package's unfused step
over a 3-step rollout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.grids import Staggered2D as JStag
from pde_control_tpu.ops import pallas_fluid as jpf
from pde_control_tpu.physics import fluid as jfluid
from pde_control_tpu_torch.grids import Domain2D as TDomain
from pde_control_tpu_torch.grids import Staggered2D as TStag
from pde_control_tpu_torch.ops import cuda_fluid as tcf
from pde_control_tpu_torch.ops.interp import _pad2, _pad2_T
from pde_control_tpu_torch.physics import fluid as tfluid

torch.set_num_threads(1)

H, B = 16, 2
_STEP = dict(dt=0.7, buoyancy=0.08, tol=1e-6, maxiter=400)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _mask(obstacles: bool):
    if not obstacles:
        return None
    m = np.zeros((H, H), np.float32)
    m[H // 2, 4:10] = 1.0
    return m


def _domains(obstacles: bool):
    m = _mask(obstacles)
    return (TDomain.create(H, H, obstacle_mask=m, device="cpu"),
            JDomain.create(H, H, obstacle_mask=None if m is None
                           else jnp.asarray(m)))


# (obstacles, force, inflow, warm, zero velocity): the cases of
# tests/test_pallas_fluid.py :: test_fused_step_matches_oracle.
CASES = {
    "obstacle-force-inflow": (True, True, True, False, False),
    "warm": (False, False, False, True, False),
    "zero-velocity": (False, False, False, False, True),
}
_JAX = {}


def _case(name):
    """Inputs, cotangents, and the JAX kernel's outputs and VJP (computed
    once per case: the interpret-mode kernel is the slow side)."""
    if name not in _JAX:
        obstacles, force, inflow, warm, zero_v = CASES[name]
        rng = np.random.default_rng(0)
        f32 = np.float32
        scale = 0.0 if zero_v else 0.5
        ins = {
            "vy": (scale * rng.standard_normal((B, H + 1, H))).astype(f32),
            "vx": (scale * rng.standard_normal((B, H, H + 1))).astype(f32),
            "rho": rng.random((B, H, H)).astype(f32),
        }
        if force:
            ins["fy"] = (0.1 * rng.standard_normal((B, H + 1, H))).astype(f32)
            ins["fx"] = (0.1 * rng.standard_normal((B, H, H + 1))).astype(f32)
        if inflow:
            ins["inflow"] = (0.05 * rng.random((B, H, H))).astype(f32)
        x0 = (0.1 * rng.standard_normal((B, H, H))).astype(f32) if warm else None
        shapes = [(B, H + 1, H), (B, H, H + 1), (B, H, H), (B, H, H)]
        cots = [rng.standard_normal(s).astype(f32) for s in shapes]
        _, jd = _domains(obstacles)
        names = list(ins)

        def step(*args):
            return jpf.fused_fluid_step(
                *args[:3], jd.acc_y, jd.acc_x, jd.fluid_mask,
                **dict(zip(names[3:], args[3:])),
                x0=None if x0 is None else jnp.asarray(x0), dx=jd.dx,
                max_shift=2, closed=True, interpret=True, **_STEP)

        def fwd_vjp(args, cots):
            out, vjp = jax.vjp(step, *args)
            return out, vjp(tuple(cots))

        out, grads = jax.jit(fwd_vjp)([jnp.asarray(ins[k]) for k in names],
                                      [jnp.asarray(c) for c in cots])
        _JAX[name] = dict(ins=ins, x0=x0, cots=cots, obstacles=obstacles,
                          out=[np.asarray(o) for o in out],
                          grads=dict(zip(names, map(np.asarray, grads))))
    return _JAX[name]


def _port_step(c, ins):
    td, _ = _domains(c["obstacles"])
    return tcf.fused_fluid_step(
        ins["vy"], ins["vx"], ins["rho"], td.acc_y, td.acc_x, td.fluid_mask,
        fy=ins.get("fy"), fx=ins.get("fx"), inflow=ins.get("inflow"),
        x0=None if c["x0"] is None else _t(c["x0"]), dx=td.dx, max_shift=2,
        closed=True, **_STEP)


@pytest.mark.parametrize("name", list(CASES))
def test_fused_step_matches_jax_kernel(name):
    """Forward (vy4, vx4, rho1, p) and the VJP of all four outputs with
    respect to every differentiable operand, through `_FusedStep`."""
    c = _case(name)
    ins = {k: _t(v).requires_grad_(True) for k, v in c["ins"].items()}
    before = (tcf.LAUNCHES_FWD, tcf.LAUNCHES_BWD)
    out = _port_step(c, ins)
    for got, want in zip(out, c["out"]):
        np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-6,
                                   rtol=1e-5)
    sum((o * _t(w)).sum() for o, w in zip(out, c["cots"])).backward()
    assert (tcf.LAUNCHES_FWD, tcf.LAUNCHES_BWD) == before  # no kernel on CPU
    for k, want in c["grads"].items():
        scale = float(np.abs(want).max()) + 1e-9
        np.testing.assert_allclose(ins[k].grad.numpy() / scale, want / scale,
                                   atol=3e-5, err_msg=k)


def _planted(rng, k, shape):
    """Displacements on every tie point of the hat and the clip, and
    between them."""
    ties = np.array([0.0, -0.0, 0.5, -0.5, 1.0, -1.0, k, -k, k + 0.7,
                     -k - 0.7, 1.5, -2.5], np.float32)
    d = rng.uniform(-k - 1, k + 1, size=shape).astype(np.float32)
    flat = d.reshape(-1)
    flat[:3 * ties.size] = np.tile(ties, 3)
    rng.shuffle(flat)
    return d


@pytest.mark.parametrize("k", [1, 2])
def test_advect_window_and_adjoint_match_jax(rng, k):
    """`_advect_window` and `_advect_window_T` against JAX's (its
    scratch-free branch) and against `jax.vjp` of JAX's forward window."""
    f = rng.random((B, H + 1, H)).astype(np.float32)
    dy, dx_ = _planted(rng, k, f.shape), _planted(rng, k, f.shape)
    g = rng.standard_normal(f.shape).astype(np.float32)
    got_out = tcf._advect_window(_t(f), _t(dy), _t(dx_), k)
    got = tcf._advect_window_T(_t(g), _t(f), _t(dy), _t(dx_), k)
    for b in range(B):
        args = [jnp.asarray(a[b]) for a in (f, dy, dx_)]
        out, vjp = jax.vjp(lambda *a: jpf._advect_window(*a, k), *args)
        np.testing.assert_allclose(got_out[b].numpy(), np.asarray(out),
                                   atol=1e-6, rtol=1e-6)
        want_T = jpf._advect_window_T(jnp.asarray(g[b]), *args, k)
        want_vjp = vjp(jnp.asarray(g[b]))
        for a, w1, w2 in zip(got, want_T, want_vjp):
            np.testing.assert_allclose(a[b].numpy(), np.asarray(w1),
                                       atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(a[b].numpy(), np.asarray(w2),
                                       atol=1e-5, rtol=1e-5)


_HELPERS = {
    "edge_pad2": (lambda t: _pad2(t, 2, "clamp"), lambda a: jpf._edge_pad2(a, 2),
                  (H, H)),
    "edge_pad2_T": (lambda t: _pad2_T(t, H, H, 2, "clamp"),
                    lambda a: jpf._edge_pad2_T(a, 2, H, H), (H + 5, H + 5)),
    "to_y_faces": (tcf._to_y_faces, jpf._to_y_faces, (H, H)),
    "to_y_faces_T": (tcf._to_y_faces_T, jpf._to_y_faces_T, (H + 1, H)),
    "to_x_faces": (tcf._to_x_faces, jpf._to_x_faces, (H, H)),
    "to_x_faces_T": (tcf._to_x_faces_T, jpf._to_x_faces_T, (H, H + 1)),
    "centers_y": (tcf._centers_y, jpf._centers_y, (H + 1, H)),
    "centers_y_T": (tcf._centers_y_T, jpf._centers_y_T, (H, H)),
    "centers_x": (tcf._centers_x, jpf._centers_x, (H, H + 1)),
    "centers_x_T": (tcf._centers_x_T, jpf._centers_x_T, (H, H)),
    "divergence_T": (lambda t: tcf._divergence_T(t, 0.5),
                     lambda a: jpf._divergence_T(a, 0.5), (H, H)),
}


@pytest.mark.parametrize("name", list(_HELPERS))
def test_plain_helper_matches_jax(rng, name):
    """Each batched stencil helper against JAX's unbatched one, per sample."""
    port, ref, shape = _HELPERS[name]
    x = rng.standard_normal((B,) + shape).astype(np.float32)
    got = port(_t(x))
    got = got if isinstance(got, tuple) else (got,)
    for b in range(B):
        want = ref(jnp.asarray(x[b]))
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), atol=1e-6,
                                       rtol=1e-6)


def test_phase_a_and_pressure_gradient_match_jax(rng):
    td, jd = _domains(True)
    f32 = np.float32
    vy = (0.5 * rng.standard_normal((B, H + 1, H))).astype(f32)
    vx = (0.5 * rng.standard_normal((B, H, H + 1))).astype(f32)
    rho = rng.random((B, H, H)).astype(f32)
    fy = (0.1 * rng.standard_normal((B, H + 1, H))).astype(f32)
    fx = (0.1 * rng.standard_normal((B, H, H + 1))).astype(f32)
    inflow = (0.05 * rng.random((B, H, H))).astype(f32)
    p = rng.standard_normal((B, H, H)).astype(f32)
    kw = dict(dt=0.7, dx=1.0, k=2, buoy=0.08)
    got = tcf._phase_a(*map(_t, (vy, vx, rho, fy, fx, inflow)), td.acc_y,
                       td.acc_x, **kw)
    got_g = tcf._pgrad_closed(_t(p), td.acc_y, td.acc_x, 1.0)
    for b in range(B):
        want = jpf._phase_a(*(jnp.asarray(a[b]) for a in
                              (vy, vx, rho, fy, fx, inflow)),
                            jd.acc_y, jd.acc_x, **kw)
        want_g = jpf._pgrad_closed(jnp.asarray(p[b]), jd.acc_y, jd.acc_x, 1.0)
        for g, w in zip(got + got_g, want + want_g):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), atol=1e-6,
                                       rtol=1e-6)


def test_fused_dispatch_in_rollout_matches_jax(rng):
    """`fluid_step(fused='cuda')` over 3 warm-started steps against the JAX
    package's unfused step: the loss and the force gradient, as
    `tests/test_pallas_fluid.py :: test_fused_dispatch_in_rollout_matches`
    holds the JAX kernel."""
    td, jd = _domains(True)
    kw = dict(dt=1.0, buoyancy=0.05, pressure_tol=1e-6, pressure_maxiter=400,
              warm_start_pressure=True)
    rho0 = rng.random((B, H, H)).astype(np.float32)
    fy = (0.05 * rng.standard_normal((B, H + 1, H))).astype(np.float32)
    fx = (0.05 * rng.standard_normal((B, H, H + 1))).astype(np.float32)
    target = rng.random((B, H, H)).astype(np.float32)

    def jloss(fy, fx):
        cfg = jfluid.FluidConfig(fused="off", **kw)
        st = jfluid.FluidState(velocity=JStag.zeros(B, H, H),
                               density=jnp.asarray(rho0),
                               pressure=jnp.zeros((B, H, H)))
        for _ in range(3):
            st = jfluid.fluid_step(st, jd, cfg, force=JStag(vy=fy, vx=fx))
        return jnp.mean((st.density - target) ** 2)

    jl, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(fy), jnp.asarray(fx))

    cfg = tfluid.FluidConfig(fused="cuda", **kw)
    tfy, tfx = _t(fy).requires_grad_(True), _t(fx).requires_grad_(True)
    st = tfluid.FluidState(velocity=TStag.zeros(B, H, H, device="cpu"),
                           density=_t(rho0), pressure=torch.zeros(B, H, H))
    before = (tcf.LAUNCHES_FWD, tcf.LAUNCHES_BWD)
    for _ in range(3):
        st = tfluid.fluid_step(st, td, cfg, force=TStag(vy=tfy, vx=tfx))
    assert st.pressure is not None
    tl = torch.mean((st.density - _t(target)) ** 2)
    tl.backward()
    assert (tcf.LAUNCHES_FWD, tcf.LAUNCHES_BWD) == before
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for got, want in zip((tfy.grad, tfx.grad), jg):
        want = np.asarray(want)
        scale = float(np.abs(want).max()) + 1e-9
        np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=3e-5)


def test_fused_pallas_name_raises():
    with pytest.raises(ValueError, match="'cuda'"):
        tfluid.FluidConfig(fused="pallas")
    with pytest.raises(ValueError, match="unknown fused mode"):
        tfluid.FluidConfig(fused="on")


@pytest.mark.parametrize("why", ["viscosity", "open", "buoyancy_factor",
                                 "too_large", "spectral_conflict"])
def test_fused_refuses_what_it_does_not_implement(why):
    n = 237 if why == "too_large" else H
    m = np.zeros((n, n), np.float32)
    m[n // 2, 2:6] = 1.0
    domain = TDomain.create(n, n, obstacle_mask=None if why ==
                            "spectral_conflict" else m,
                            closed=why != "open", device="cpu")
    cfg = tfluid.FluidConfig(fused="cuda", viscosity=0.1 if why ==
                             "viscosity" else 0.0)
    state = tfluid.FluidState.zeros(1, n, n, device="cpu")
    factor = torch.ones(1, 1, 1) if why == "buoyancy_factor" else None
    match = "spectral" if why == "spectral_conflict" else "not supported"
    with pytest.raises(ValueError, match=match):
        tfluid.fluid_step(state, domain, cfg, buoyancy_factor=factor)


def test_fused_spectral_conflict_accepts_explicit_pcg():
    """An obstacle-free domain takes the fused step once the caller accepts
    the tol-bounded solve; (H, W) inflow broadcasts over the batch."""
    domain = TDomain.create(H, H, device="cpu")
    cfg = tfluid.FluidConfig(fused="cuda", pressure_backend="pcg")
    state = tfluid.FluidState.zeros(2, H, H, device="cpu")
    inflow = torch.zeros(H, H)
    inflow[2:4, 6:10] = 1.0
    out = tfluid.fluid_step(state, domain, cfg, inflow=inflow)
    assert out.pressure is None
    np.testing.assert_allclose(out.density.numpy(),
                               np.broadcast_to(inflow.numpy(), (2, H, H)))


@pytest.mark.parametrize("h,w,fits", [(64, 64, True), (84, 84, True),
                                      (85, 85, True), (32, 48, True),
                                      (128, 128, True), (136, 136, True),
                                      (237, 237, False)])
def test_fused_fits_gate(h, w, fits):
    """The JAX package's fused gate (squares to 236²): in the small layout
    to 108² (K2) and 111² (K3), in the cluster core's large one beyond, and
    in the banded one from 146² (K2) and 152² (K3); the shared memory of
    the three layouts, and K3's banded scratch, as the C source counts them
    (the build phase of chip_smoke.py compares the two on the card): at
    236² and C = 16 the reduction area, the solve's bands (x, z, t, r:
    15 rows; d: 17; z's halo rows: 2) and slices (8·512) and K2's band
    fields (vy3 16 rows, vx3 15 × 237 = 3,555 floats, 16-byte aligned to
    3,556, rho1 17, a row of p), or K3's best
    iterate (15 rows); K3's window phase (231,920 B a rank) in the
    scratch beside the solve's two whole fields."""
    assert tcf.fused_step_fits(h, w) is fits
    assert tcf.fwd_shared_bytes(64, 64, 8, 512) == 99_360
    assert tcf.fwd_shared_bytes(128, 128, 8, 512) == 209_728
    assert tcf.bwd_shared_bytes(128, 128, 8, 512, 2) == 191_232
    band = 4 * 15 * 236 + 17 * 236 + 2 * 236 + 8 * 512
    assert tcf.fwd_shared_bytes(236, 236, 16, 512) == 4 * (
        192 + band + 16 * 236 + 3_556 + 17 * 236 + 236) == 138_048
    assert tcf.bwd_shared_bytes(236, 236, 16, 512, 2) == 4 * (
        192 + 15 * 236 + band) == 105_888
    assert tcf.bwd_scratch_floats(236, 236, 16, 2) == (
        2 * 236 * 236 + 16 * 231_920 // 4)
