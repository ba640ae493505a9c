"""The split 2D fluid step (`parallel/spatial.py`) on (1, 2), (2, 2) and
(1, 4) worlds of gloo ranks on the CPU, against the JAX package's
`spatial_fluid_step` on `make_mesh2d` meshes. On (1, 4) the slabs are 4
rows (max_shift 2 needs k + 2 = 4), and the two middle ranks send and
receive halos on both sides.

At 16², batch 4, three steps from rest with a random force, dt 0.5,
buoyancy 0.1, the pressure solved to tol 1e-7 (maxiter 800) so that
every CG mode converges far below the comparison tolerance. The ranks
(`tests/_torch_dist.py`) run every mode on every world: 'jax', 'pcg' and
'pcg2' with a two-row plate across the slabs' boundary at max_shift 2,
and 'spectral' without obstacles at max_shift 1 (a JAX compile of half
the time); each rank's blocks are gathered. JAX
references (one compile each, taken here while the ranks run): 'pcg' on
the plate on a (2, 2) mesh, which the three CG modes are held to (they
solve the same system to the same tight tol; the JAX package's own check
holds its 'pcg2' to the dense one-level PCG in this way), and 'spectral'
on a (1, 2) mesh. Held to the JAX package's check
(`tests/_spatial_equality_check.py`): the loss at rtol 1e-5, the final
state at rtol 1e-4, atol 1e-6, the force's gradient at rtol 1e-3, atol
2e-5.

The sampler's ties: `_sample_shift_local` against the JAX package's
function of the same name (plain jnp code, differentiated by JAX) at
displacements on integers, on ±max_shift and beyond it, with every
gradient within 1e-6. Also: the reduce-scatter's backward (the
all-gathered gradient), `spatial_shard` / `spatial_gather` round trips,
`spatial_spec` and the step's scope errors.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import _torch_dist as td
from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.grids import Staggered2D as JStaggered
from pde_control_tpu.parallel import spatial as jspatial
from pde_control_tpu.physics.fluid import FluidConfig as JConfig
from pde_control_tpu.physics.fluid import FluidState as JState
from pde_control_tpu_torch import Domain2D, FluidConfig, FluidState
from pde_control_tpu_torch.parallel import spatial

torch.set_num_threads(1)

B, H, W, STEPS = 4, 16, 16, 3
# name: (pressure backend, plate, max_shift)
CASES = {"jax": ("jax", True, 2), "pcg": ("pcg", True, 2),
         "pcg2": ("pcg2", True, 2), "spectral": ("spectral", False, 1)}
WORLDS = [(1, 2), (2, 2), (1, 4)]
REF_OF = {"jax": "pcg", "pcg": "pcg", "pcg2": "pcg", "spectral": "spectral"}


def _blob(rng, b, h, w):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    c = rng.uniform(h * 0.2, h * 0.8, (b, 2))
    return np.exp(-((yy[None] - c[:, 0, None, None]) ** 2
                    + (xx[None] - c[:, 1, None, None]) ** 2)
                  / (0.03 * h * w)).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(0)
    plate = np.zeros((H, W), np.float32)
    plate[7:9, 4:12] = 1.0  # across a slabs' boundary on every world
    return dict(density=_blob(rng, B, H, W),
                fy=rng.normal(0, 0.05, (B, H + 1, W)).astype(np.float32),
                fx=rng.normal(0, 0.05, (B, H, W + 1)).astype(np.float32),
                target=_blob(np.random.default_rng(7), B, H, W),
                plate=plate)


def _jax_reference(inputs, mode, plate, k, mesh_shape):
    domain = JDomain.create(H, W, obstacle_mask=(
        jnp.asarray(inputs["plate"]) if plate else None))
    cfg = JConfig(dt=0.5, buoyancy=0.1, pressure_tol=1e-7,
                  pressure_maxiter=800, pressure_backend=mode, max_shift=k)
    mesh = jspatial.make_mesh2d(*mesh_shape)
    state0 = JState(velocity=JStaggered.zeros(B, H, W),
                    density=jnp.asarray(inputs["density"]))
    force = JStaggered(vy=jnp.asarray(inputs["fy"]),
                       vx=jnp.asarray(inputs["fx"]))
    target = jnp.asarray(inputs["target"])

    def loss_fn(force):
        def body(s, _):
            return jspatial.spatial_fluid_step(s, domain, cfg, mesh,
                                               force=force), None

        final, _ = lax.scan(body, state0, None, length=STEPS)
        return jnp.mean((final.density - target) ** 2), final

    (loss, final), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        force)
    return dict(loss=float(loss), density=np.asarray(final.density),
                vy=np.asarray(final.velocity.vy),
                vx=np.asarray(final.velocity.vx), gvy=np.asarray(g.vy),
                gvx=np.asarray(g.vx))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial")
    inputs = _inputs()
    handles = {w: td.start_ranks(td.spatial_cases, w[0] * w[1],
                                 tmp / f"w{w[0]}{w[1]}", w[0], w[1], inputs,
                                 CASES, STEPS) for w in WORLDS}
    refs = {name: _jax_reference(inputs, *CASES[name], mesh_shape)
            for name, mesh_shape in (("pcg", (2, 2)), ("spectral", (1, 2)))}
    return refs, {w: td.join_ranks(h)[0] for w, h in handles.items()}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_jax(runs, world, case):
    refs, got = runs
    np.testing.assert_allclose(got[world][case]["loss"],
                               refs[REF_OF[case]]["loss"], rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_final_state_matches_jax(runs, world, case):
    refs, got = runs
    for key in ("density", "vy", "vx"):
        np.testing.assert_allclose(got[world][case][key],
                                   refs[REF_OF[case]][key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_force_gradient_matches_jax(runs, world, case):
    refs, got = runs
    for key in ("gvy", "gvx"):
        ref = refs[REF_OF[case]][key]
        assert np.abs(ref).max() > 1e-5
        np.testing.assert_allclose(got[world][case][key], ref, rtol=1e-3,
                                   atol=2e-5, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_layout_round_trips_and_reduce_scatter_backward(runs, world):
    _, got = runs
    checks = got[world]["_checks"]
    assert checks == {"round_trip": True, "reduce_scatter": True,
                      "reduce_scatter_grad": True}, checks


# ------------------------------------------------------- sampler ties

def _tie_inputs(k):
    rng = np.random.default_rng(11)
    hk, w = 6, 8
    vals = np.array([0.0, 1.0, -1.0, float(k), -float(k), k + 1.0,
                     -(k + 1.0), 0.5, -1.5, k - 0.5], np.float32)
    dy = rng.choice(vals, size=(2, hk, w)).astype(np.float32)
    dx = rng.choice(vals, size=(2, hk, w)).astype(np.float32)
    dy[0, 0, :len(vals) - 2] = vals[:-2]   # every tie on both axes
    dx[0, 1, :len(vals) - 2] = vals[:-2]
    return dict(field=rng.normal(size=(2, hk, w)).astype(np.float32),
                dy=dy, dx=dx,
                below=rng.normal(size=(2, k, w)).astype(np.float32),
                above=rng.normal(size=(2, k + 1, w)).astype(np.float32),
                cot=rng.normal(size=(2, hk, w)).astype(np.float32))


@pytest.mark.parametrize("k", [1, 2])
def test_sampler_ties_match_jax_autodiff(k):
    x = _tie_inputs(k)
    names = ("field", "dy", "dx", "below", "above")

    def jloss(field, dy, dx, below, above):
        out = jspatial._sample_shift_local(field, dy, dx, k, below, above)
        return jnp.sum(out * x["cot"]), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                           has_aux=True)(
        *(jnp.asarray(x[n]) for n in names))
    t = {n: torch.tensor(x[n], requires_grad=True) for n in names}
    out = spatial._sample_shift_local(t["field"], t["dy"], t["dx"], k,
                                      t["below"], t["above"])
    (out * torch.tensor(x["cot"])).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-6)
    for n, g in zip(names, jgrads):
        np.testing.assert_allclose(t[n].grad.numpy(), np.asarray(g),
                                   atol=1e-6, err_msg=n)


# ------------------------------------------------------ scope, specs

def test_spatial_spec_convention():
    assert spatial.spatial_spec(3, 2) == ("data", "space", None)
    assert spatial.spatial_spec(2, 2) == ("space", None)
    assert spatial.spatial_spec(4, 3) == ("data", "space", None, None)
    assert spatial.spatial_spec(3, 3) == ("space", None, None)
    assert spatial.spatial_spec(1, 2) == ()
    with pytest.raises(ValueError):
        spatial.spatial_spec(3, 4)


def test_step_scope_validation():
    """The JAX package's scope errors, before any collective (only
    mesh.shape is read)."""
    mesh = types.SimpleNamespace(shape={"data": 1, "space": 2})
    state = FluidState.zeros(2, 16, 16, device="cpu")
    step = spatial.spatial_fluid_step
    with pytest.raises(ValueError, match="closed"):
        step(state, Domain2D.create(16, 16, closed=False, device="cpu"),
             FluidConfig(), mesh)
    domain = Domain2D.create(16, 16, device="cpu")
    with pytest.raises(ValueError, match="viscosity"):
        step(state, domain, FluidConfig(viscosity=0.1), mesh)
    with pytest.raises(ValueError, match="shift"):
        step(state, domain, FluidConfig(advection_mode="gather"), mesh)
    for backend in ("pallas", "cuda"):
        with pytest.raises(ValueError, match="single-device"):
            step(state, domain, FluidConfig(pressure_backend=backend), mesh)
    obs = np.zeros((16, 16), np.float32)
    obs[8, 4:12] = 1.0
    with pytest.raises(ValueError, match="obstacles"):
        step(state, Domain2D.create(16, 16, obstacle_mask=obs, device="cpu"),
             FluidConfig(pressure_backend="spectral"), mesh)
    with pytest.raises(ValueError, match="divisible"):
        step(state, domain, FluidConfig(),
             types.SimpleNamespace(shape={"data": 1, "space": 3}))
    with pytest.raises(ValueError, match="max_shift"):
        step(state, domain, FluidConfig(max_shift=2),
             types.SimpleNamespace(shape={"data": 1, "space": 8}))
