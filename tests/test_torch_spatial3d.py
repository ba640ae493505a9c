"""The split 3D fluid step (`parallel/spatial3d.py`) on (1, 4) and (2, 2)
worlds of gloo ranks on the CPU, against the JAX package.

At 16³, batch 2, two steps from rest with a random force, dt 0.5,
buoyancy 0.1, max_shift 1, the pressure solved to tol 1e-7 (maxiter 800)
so that every CG mode converges far below the comparison tolerance. A
two-plane plate at planes 7:9 lies across a slab boundary on both worlds
(slabs of 4 planes on (1, 4), whose middle ranks send and receive on both
sides; of 8 on (2, 2)). The ranks (`tests/_torch_dist.py`) run the cases:
  * 'pcg' on the plate with the force, an inflow, a full-field buoyancy
    factor and a warm-started pressure; 'jax' on the same inputs. Both are
    held to one JAX reference: the JAX package's `spatial_fluid3d_step` in
    'pcg' on a `make_mesh2d(1, 2)` mesh (they solve one system to one
    tight tol), with the gradients of the force and the factor;
  * 'spectral' without obstacles, with the force: held to the JAX
    package's dense `fluid3d_step` ('spectral');
  * 'perbatch', 'pcg' on the plate with a per-batch (B, 1, 1, 1) factor
    (replicated over the space group: its gradient is summed over it):
    held to the port's dense `fluid3d_step` ('pcg'), which
    tests/test_torch_smoke3d.py holds to the JAX package.
The loss is the squared error of the final density summed per sample
(the gradients then stand far above the atol). Each rank's blocks are
gathered. Tolerances, the JAX package's check's
(`tests/_spatial3d_equality_check.py`): the loss at rtol 1e-5, the final
state at rtol 1e-4, atol 1e-6, the gradients at rtol 1e-3, atol 2e-5.

Also: the sampler's ties (`_sample_shift_local3d` against the JAX
package's function of the same name, every gradient within 1e-6), the
`spatial_shard` / `spatial_gather` round trips of a `FluidState3D` and a
`Staggered3D` with the top face's gradient summed once,
`spatial_pressure_solve3d_diag` (the same trips on every rank; the
relative residual of the deflated system at most 10 × tol under the
port's dense masked operator), and the step's scope errors.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import _torch_dist as td
from pde_control_tpu.grids3d import Domain3D as JDomain
from pde_control_tpu.grids3d import Staggered3D as JStaggered
from pde_control_tpu.parallel import spatial as jspatial
from pde_control_tpu.parallel import spatial3d as jspatial3d
from pde_control_tpu.physics.fluid3d import Fluid3DConfig as JConfig
from pde_control_tpu.physics.fluid3d import FluidState3D as JState
from pde_control_tpu.physics.fluid3d import fluid3d_step as jfluid3d_step
from pde_control_tpu_torch import (
    Domain3D,
    Fluid3DConfig,
    FluidState3D,
    Staggered3D,
    fluid3d_step,
)
from pde_control_tpu_torch.parallel import spatial3d
from pde_control_tpu_torch.physics.poisson import masked_laplace_spd

torch.set_num_threads(1)

B, D, STEPS = 2, 16, 2
# name: (pressure backend, plate, buoyancy factor)
CASES = {"pcg": ("pcg", True, "full"), "jax": ("jax", True, "full"),
         "spectral": ("spectral", False, None),
         "perbatch": ("pcg", True, "batch")}
WORLDS = [(1, 4), (2, 2)]
REF_OF = {"pcg": "pcg", "jax": "pcg", "spectral": "spectral",
          "perbatch": "perbatch"}
TOL = 1e-5  # the diagnostic solve's


def _blob3(rng, b, d):
    zz, yy, xx = np.meshgrid(*(np.arange(d),) * 3, indexing="ij")
    c = rng.uniform(d * 0.25, d * 0.75, (b, 3))
    return np.exp(-((zz[None] - c[:, 0, None, None, None]) ** 2
                    + (yy[None] - c[:, 1, None, None, None]) ** 2
                    + (xx[None] - c[:, 2, None, None, None]) ** 2)
                  / (0.06 * d * d)).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(0)
    plate = np.zeros((D, D, D), np.float32)
    plate[7:9, 4:12, 4:12] = 1.0  # across a slab boundary on both worlds
    fluid = 1.0 - plate

    def normal(*shape):
        return rng.normal(0, 0.05, (B,) + shape).astype(np.float32)

    return dict(
        density=_blob3(rng, B, D), fz=normal(D + 1, D, D),
        fy=normal(D, D + 1, D), fx=normal(D, D, D + 1),
        target=_blob3(np.random.default_rng(7), B, D),
        inflow=0.05 * _blob3(np.random.default_rng(3), B, D),
        bf_full=0.1 + 0.05 * _blob3(np.random.default_rng(5), B, D),
        bf_batch=np.array([0.15, 0.2], np.float32).reshape(B, 1, 1, 1),
        div=(np.random.default_rng(1).normal(0, 1, (B, D, D, D))
             * fluid).astype(np.float32),
        plate=plate)


def _jax_reference(inputs, mode, plate, factor, mesh_shape):
    """The JAX package's rollout: `spatial_fluid3d_step` on a mesh of
    `mesh_shape`, or the dense `fluid3d_step` when it is None."""
    domain = JDomain.create(D, D, D, obstacle_mask=(
        jnp.asarray(inputs["plate"]) if plate else None))
    cfg = JConfig(dt=0.5, buoyancy=0.1, pressure_tol=1e-7,
                  pressure_maxiter=800, pressure_backend=mode)
    extra = {} if factor is None else dict(
        inflow=jnp.asarray(inputs["inflow"]),
        pressure=jnp.zeros((B, D, D, D), jnp.float32))
    state0 = JState(velocity=JStaggered.zeros(B, D, D, D),
                    density=jnp.asarray(inputs["density"]), **extra)
    force = JStaggered(*(jnp.asarray(inputs[k]) for k in ("fz", "fy", "fx")))
    bf = None if factor is None else jnp.asarray(inputs[f"bf_{factor}"])
    target = jnp.asarray(inputs["target"])
    if mesh_shape is None:
        step = jfluid3d_step
    else:
        mesh = jspatial.make_mesh2d(*mesh_shape)

        def step(s, domain, cfg, **kw):
            return jspatial3d.spatial_fluid3d_step(s, domain, cfg, mesh, **kw)

    def loss_fn(force, bf):
        def body(s, _):
            return step(s, domain, cfg, force=force,
                        buoyancy_factor=bf), None

        final, _ = lax.scan(body, state0, None, length=STEPS)
        return jnp.sum((final.density - target) ** 2) / B, final

    (loss, final), (g, gbf) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(force, bf)
    out = dict(loss=float(loss), density=np.asarray(final.density),
               vz=np.asarray(final.velocity.vz),
               vy=np.asarray(final.velocity.vy),
               vx=np.asarray(final.velocity.vx), gvz=np.asarray(g.vz),
               gvy=np.asarray(g.vy), gvx=np.asarray(g.vx))
    if gbf is not None:
        out["gbf"] = np.asarray(gbf)
    return out


def _port_dense_reference(inputs, mode, factor):
    """The port's dense `fluid3d_step` rollout on the plate."""
    t = {k: torch.tensor(v) for k, v in inputs.items()}
    domain = Domain3D.create(D, D, D, obstacle_mask=t["plate"], device="cpu")
    cfg = Fluid3DConfig(dt=0.5, buoyancy=0.1, pressure_tol=1e-7,
                        pressure_maxiter=800, pressure_backend=mode)
    state = FluidState3D(velocity=Staggered3D.zeros(B, D, D, D, device="cpu"),
                         density=t["density"], inflow=t["inflow"],
                         pressure=torch.zeros(B, D, D, D))
    force = Staggered3D(*(t[k].clone().requires_grad_()
                          for k in ("fz", "fy", "fx")))
    bf = t[f"bf_{factor}"].clone().requires_grad_()
    for _ in range(STEPS):
        state = fluid3d_step(state, domain, cfg, force=force,
                             buoyancy_factor=bf)
    loss = torch.sum((state.density - t["target"]) ** 2) / B
    loss.backward()
    v = state.velocity
    return dict(loss=loss.item(), density=td._np(state.density),
                vz=td._np(v.vz), vy=td._np(v.vy), vx=td._np(v.vx),
                gvz=td._np(force.vz.grad), gvy=td._np(force.vy.grad),
                gvx=td._np(force.vx.grad), gbf=td._np(bf.grad))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial3d")
    inputs = _inputs()
    handles = {w: td.start_ranks(td.spatial3d_cases, w[0] * w[1],
                                 tmp / f"w{w[0]}{w[1]}", w[0], w[1], inputs,
                                 CASES, STEPS) for w in WORLDS}
    refs = {"pcg": _jax_reference(inputs, *CASES["pcg"], (1, 2)),
            "spectral": _jax_reference(inputs, *CASES["spectral"], None),
            "perbatch": _port_dense_reference(inputs, "pcg", "batch")}
    return inputs, refs, {w: td.join_ranks(h) for w, h in handles.items()}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_reference(runs, world, case):
    _, refs, got = runs
    np.testing.assert_allclose(got[world][0][case]["loss"],
                               refs[REF_OF[case]]["loss"], rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_final_state_matches_reference(runs, world, case):
    _, refs, got = runs
    for key in ("density", "vz", "vy", "vx"):
        np.testing.assert_allclose(got[world][0][case][key],
                                   refs[REF_OF[case]][key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_reference(runs, world, case):
    _, refs, got = runs
    ref = refs[REF_OF[case]]
    keys = [k for k in ("gvz", "gvy", "gvx", "gbf") if k in ref]
    assert keys == [k for k in ("gvz", "gvy", "gvx", "gbf")
                    if k in got[world][0][case]]
    for key in keys:
        assert np.abs(ref[key]).max() > 1e-3, key  # 50 × atol
        np.testing.assert_allclose(got[world][0][case][key], ref[key],
                                   rtol=1e-3, atol=2e-5, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_layout_round_trips_and_top_face_gradient(runs, world):
    _, _, got = runs
    checks = got[world][0]["_checks"]
    assert checks == {"round_trip": True, "block_shapes": True,
                      "grad_sum": True}, checks


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ["pcg", "jax"])
def test_pressure_solve_diag(runs, world, mode):
    """Every rank ran the same trips, and the gathered pressure solves the
    deflated system under the port's dense masked operator to 10 × tol."""
    inputs, _, got = runs
    trips = [r[f"diag_{mode}"]["trips"] for r in got[world]]
    assert len(set(trips)) == 1 and 0 < trips[0] < 2000, trips
    domain = Domain3D.create(D, D, D, obstacle_mask=inputs["plate"],
                             dtype=torch.float64, device="cpu")
    fluid = domain.fluid_mask > 0
    p = torch.tensor(got[world][0][f"diag_{mode}"]["p"], dtype=torch.float64)
    for i, ap in enumerate(masked_laplace_spd(p, domain)):
        rhs = torch.where(fluid, -torch.tensor(inputs["div"][i]).double(), 0.0)
        rhs = torch.where(fluid, rhs - rhs[fluid].mean(), 0.0)
        ap = torch.where(fluid, ap - ap[fluid].mean(), ap)
        rel = float((ap - rhs)[fluid].norm() / rhs[fluid].norm())
        assert rel <= 10 * TOL, (i, rel)


def test_preconditioner_cuts_trips(runs):
    _, _, got = runs
    for world in WORLDS:
        pcg, plain = (got[world][0][f"diag_{m}"]["trips"]
                      for m in ("pcg", "jax"))
        assert pcg < plain, (world, pcg, plain)


# ------------------------------------------------------- sampler ties

def _tie_inputs(k):
    rng = np.random.default_rng(11)
    zk, h, w = 4, 5, 6
    vals = np.array([0.0, 1.0, -1.0, float(k), -float(k), k + 1.0,
                     -(k + 1.0), 0.5, -1.5, k - 0.5], np.float32)
    disp = {a: rng.choice(vals, size=(2, zk, h, w)).astype(np.float32)
            for a in ("dz", "dy", "dx")}
    for i, a in enumerate(("dz", "dy", "dx")):   # every tie on every axis
        disp[a][0, i, 0, :len(vals) - 4] = vals[:-4]
    return dict(field=rng.normal(size=(2, zk, h, w)).astype(np.float32),
                below=rng.normal(size=(2, k, h, w)).astype(np.float32),
                above=rng.normal(size=(2, k + 1, h, w)).astype(np.float32),
                cot=rng.normal(size=(2, zk, h, w)).astype(np.float32),
                **disp)


@pytest.mark.parametrize("k", [1, 2])
def test_sampler_ties_match_jax_autodiff(k):
    x = _tie_inputs(k)
    names = ("field", "dz", "dy", "dx", "below", "above")

    def jloss(field, dz, dy, dx, below, above):
        out = jspatial3d._sample_shift_local3d(field, dz, dy, dx, k, below,
                                               above)
        return jnp.sum(out * x["cot"]), out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True)(
        *(jnp.asarray(x[n]) for n in names))
    t = {n: torch.tensor(x[n], requires_grad=True) for n in names}
    out = spatial3d._sample_shift_local3d(t["field"], t["dz"], t["dy"],
                                          t["dx"], k, t["below"], t["above"])
    (out * torch.tensor(x["cot"])).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-6)
    for n, g in zip(names, jgrads):
        np.testing.assert_allclose(t[n].grad.numpy(), np.asarray(g),
                                   atol=1e-6, err_msg=n)


# -------------------------------------------------------------- scope

def test_step_scope_validation():
    """The JAX package's scope errors, before any collective (only
    mesh.shape is read)."""
    def mesh(space):
        return types.SimpleNamespace(shape={"data": 1, "space": space})

    state = FluidState3D.zeros(2, 16, 16, 16, device="cpu")
    step = spatial3d.spatial_fluid3d_step
    with pytest.raises(ValueError, match="closed"):
        step(state, Domain3D.create(16, 16, 16, closed=False, device="cpu"),
             Fluid3DConfig(), mesh(2))
    domain = Domain3D.create(16, 16, 16, device="cpu")
    with pytest.raises(ValueError, match="viscosity"):
        step(state, domain, Fluid3DConfig(viscosity=0.1), mesh(2))
    with pytest.raises(ValueError, match="shift"):
        step(state, domain, Fluid3DConfig(advection_mode="gather"), mesh(2))
    for backend in ("pallas", "cuda"):
        with pytest.raises(ValueError, match="single-device"):
            step(state, domain, Fluid3DConfig(pressure_backend=backend),
                 mesh(2))
    with pytest.raises(ValueError, match="unknown"):
        step(state, domain, Fluid3DConfig(pressure_backend="pcg2"), mesh(2))
    obs = np.zeros((16, 16, 16), np.float32)
    obs[8, 4:12, 4:12] = 1.0
    with pytest.raises(ValueError, match="obstacles"):
        step(state, Domain3D.create(16, 16, 16, obstacle_mask=obs,
                                    device="cpu"),
             Fluid3DConfig(pressure_backend="spectral"), mesh(2))
    with pytest.raises(ValueError, match="divisible"):
        step(state, domain, Fluid3DConfig(), mesh(3))
    flat = Domain3D.create(16, 6, 16, device="cpu")
    with pytest.raises(ValueError, match="y-mode"):
        step(FluidState3D.zeros(2, 16, 6, 16, device="cpu"), flat,
             Fluid3DConfig(pressure_backend="spectral"), mesh(4))
    with pytest.raises(ValueError, match="max_shift"):
        step(state, domain, Fluid3DConfig(max_shift=2), mesh(8))
    with pytest.raises(ValueError, match="obstacles"):
        spatial3d.spatial_pressure_solve3d_diag(
            torch.zeros(1, 16, 16, 16), Domain3D.create(
                16, 16, 16, obstacle_mask=obs, device="cpu"), mesh(2),
            mode="spectral")
