"""The port's fluid step against the JAX package, on the bench geometry.

One `fluid_step` and a 4-step rollout at 32² with the bench plate
(`obstacle[h//2, h//4:h//2]`, closed box), buoyancy 0.08 and a warm-started
pressure solve at tol 1e-6. Forward values and the VJP with respect to vy,
vx, rho and the force agree at rtol 1e-4 (atol 1e-4 of the field's scale
for entries near zero). Those comparisons are in
`tests/test_torch_fluid_vjp.py` (a file of at most five tests, which the
test run hands out last); this file holds the rest of the step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.grids import Staggered2D as JStag
from pde_control_tpu.physics import fluid as jfluid
from pde_control_tpu_torch.grids import Domain2D as TDomain
from pde_control_tpu_torch.grids import Staggered2D as TStag
from pde_control_tpu_torch.physics import fluid as tfluid

torch.set_num_threads(1)

H = 32


def _plate():
    m = np.zeros((H, H), np.float32)
    m[H // 2, H // 4:H // 2] = 1.0
    return m


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _cfgs(backend="auto"):
    kw = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-6, pressure_maxiter=500,
              warm_start_pressure=True)
    return (tfluid.FluidConfig(pressure_backend=backend, **kw),
            jfluid.FluidConfig(pressure_backend={"cuda": "pallas"}.get(
                backend, backend), **kw))


def _inputs(rng, start: str, batch: int = 2):
    scale = 0.0 if start == "rest" else 0.4
    return [
        (scale * rng.normal(size=(batch, H + 1, H))).astype(np.float32),
        (scale * rng.normal(size=(batch, H, H + 1))).astype(np.float32),
        rng.uniform(0, 1, size=(batch, H, H)).astype(np.float32),
        (0.02 * rng.normal(size=(batch, H + 1, H))).astype(np.float32),
        (0.02 * rng.normal(size=(batch, H, H + 1))).astype(np.float32),
    ]


def test_divergence_free_projects(rng):
    m = _plate()
    td = TDomain.create(H, H, obstacle_mask=m, device="cpu")
    tcfg, _ = _cfgs()
    vy, vx = _inputs(rng, "moving")[:2]
    v, p = tfluid.divergence_free(TStag(_t(vy), _t(vx)), td, tcfg)
    div = v.divergence() * td.fluid_mask
    assert float(div.abs().max()) < 1e-4
    assert float((v.vy * (1 - td.acc_y)).abs().max()) == 0.0


def test_fused_modes():
    assert tfluid.FluidConfig(fused="off").fused == "off"
    assert tfluid.FluidConfig(fused="cuda").fused == "cuda"
    with pytest.raises(ValueError, match="fused='cuda'"):
        tfluid.FluidConfig(fused="pallas")
    with pytest.raises(ValueError):
        tfluid.FluidConfig(fused="bogus")


def test_step_with_inflow_buoyancy_factor_and_viscosity(rng):
    """The step's other inputs: a per-sample smoke source, a per-sample
    buoyancy factor (B, 1, 1) and viscous diffusion; forward and VJP."""
    m = _plate()
    td = TDomain.create(H, H, obstacle_mask=m, device="cpu")
    jd = JDomain.create(H, H, obstacle_mask=jnp.asarray(m))
    kw = dict(dt=0.5, viscosity=0.1, buoyancy=0.08, pressure_tol=1e-6,
              pressure_maxiter=500)
    tcfg, jcfg = tfluid.FluidConfig(**kw), jfluid.FluidConfig(**kw)
    vy, vx, rho = _inputs(rng, "moving")[:3]
    inflow = rng.uniform(0, 0.1, size=rho.shape).astype(np.float32)
    factor = rng.uniform(0.05, 0.2, size=(2, 1, 1)).astype(np.float32)
    wy = rng.normal(size=vy.shape).astype(np.float32)

    def run(mod, stag, domain, cfg, vy, vx, rho, inflow, factor):
        state = mod.FluidState(velocity=stag(vy, vx), density=rho)
        out = mod.fluid_step(state, domain, cfg, buoyancy_factor=factor,
                             inflow=inflow)
        return out.velocity.vy, out.density

    (j_vy, j_rho), vjp = jax.vjp(
        lambda *a: run(jfluid, JStag, jd, jcfg, *a),
        *[jnp.asarray(a) for a in (vy, vx, rho, inflow, factor)])
    j_grads = vjp((jnp.asarray(wy), jnp.ones_like(j_rho)))
    t_args = [_t(a).requires_grad_(True) for a in (vy, vx, rho, inflow, factor)]
    t_vy, t_rho = run(tfluid, TStag, td, tcfg, *t_args)
    ((t_vy * _t(wy)).sum() + t_rho.sum()).backward()
    for a, b in [(t_vy, j_vy), (t_rho, j_rho)] + [
            (t.grad, g) for t, g in zip(t_args, j_grads)]:
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("control", ["buoyancy", "direct"])
def test_pde_glue_matches_jax(rng, control):
    """IncompressibleFluidPDE's net glue, costs and initial state."""
    from pde_control_tpu.control.pde_fluid import IncompressibleFluidPDE as JPDE
    from pde_control_tpu_torch.control.pde_fluid import IncompressibleFluidPDE as TPDE

    m = _plate()
    tcfg, jcfg = _cfgs()
    tpde = TPDE(TDomain.create(H, H, obstacle_mask=m, dx=0.5, device="cpu"), tcfg,
                control=control)
    jpde = JPDE(JDomain.create(H, H, obstacle_mask=jnp.asarray(m), dx=0.5),
                jcfg, control=control)
    obs = rng.uniform(0, 1, size=(2, 3, H, H, 1)).astype(np.float32)
    vy, vx = _inputs(rng, "moving")[:2]
    batch = {"obs": obs, "vy0": vy, "vx0": vx}
    ts = tpde.initial_state({k: _t(v) for k, v in batch.items()})
    js = jpde.initial_state({k: jnp.asarray(v) for k, v in batch.items()})
    _close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    _close(ts.pressure, js.pressure)
    _close(tpde.observe(ts), jpde.observe(js))
    tgt = obs[:, 1]
    _close(tpde.cfe_inputs(ts, _t(tgt)), jpde.cfe_inputs(js, jnp.asarray(tgt)))
    _close(tpde.op_inputs(_t(obs[:, 0]), _t(tgt)),
           jpde.op_inputs(jnp.asarray(obs[:, 0]), jnp.asarray(tgt)))
    net_out = rng.normal(size=(2, H, H, 1 if control == "buoyancy" else 2))
    net_out = net_out.astype(np.float32)
    tf = tpde.force_from_net(_t(net_out), ts)
    jf = jpde.force_from_net(jnp.asarray(net_out), js)
    _close(tf.vy, jf.vy)
    _close(tf.vx, jf.vx)
    _close(tpde.force_cost(tf), jpde.force_cost(jf))
    _close(tpde.force_abs_mean(tf), jpde.force_abs_mean(jf))
    assert tpde.build_cfe().Conv_4.weight.shape[0] == net_out.shape[-1]
