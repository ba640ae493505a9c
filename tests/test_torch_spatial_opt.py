"""The spatial adjoint (`parallel/spatial_opt.py`), the warm-started
indirect inflow step and the diagnostic solve (`parallel/spatial.py`) on
gloo ranks on the CPU, against the JAX package.

* `optimize_forces_spatial` on (1, 2) and (2, 2) worlds, as the JAX
  package's check (`tests/_spatial_equality_check.py :: main_opt`) runs
  it: 16², batch 2, n=2, 6 clipped Adam steps at lr 2.0, force_reg 1e-5,
  the exact spectral solve; its history (total, obs_loss, force_cost)
  against the JAX function's on a (1, 2) mesh at the gradient tolerance (rtol 1e-3,
  atol 2e-5), and the final forces at a relative norm error of 1e-4
  (six Adam steps of up to lr = 2.0 each amplify a rounding of a small
  gradient entry into a single entry's 1e-3); the observation loss falls
  by at least 10%.
* The indirect channel on a (2, 2) world (`main_indirect`): a per-sample
  buoyancy factor, an inflow field and a warm-started pressure, two steps
  on the plate with 'pcg' at tol 1e-7: the loss at rtol 1e-5 and the
  buoyancy factor's gradient at rtol 1e-3, atol 2e-5 against the JAX
  package's step on a (2, 2) mesh.
* `spatial_pressure_solve_diag` on both worlds at 64² with the bench
  plate (`main_iters2` runs 128² on 8 devices): 'pcg' and 'pcg2' agree
  at rtol 1e-3, atol 1e-4 and 'pcg2' takes fewer trips.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import _torch_dist as td
from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.grids import Staggered2D as JStaggered
from pde_control_tpu.parallel.spatial import make_mesh2d, spatial_fluid_step
from pde_control_tpu.parallel.spatial_opt import optimize_forces_spatial
from pde_control_tpu.physics.fluid import FluidConfig as JConfig
from pde_control_tpu.physics.fluid import FluidState as JState

torch.set_num_threads(1)

OPT = dict(n=2, iterations=6, learning_rate=2.0, force_reg=1e-5)
G_RTOL, G_ATOL = 1e-3, 2e-5


def _blob(rng, b, h, w):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    c = rng.uniform(h * 0.2, h * 0.8, (b, 2))
    return np.exp(-((yy[None] - c[:, 0, None, None]) ** 2
                    + (xx[None] - c[:, 1, None, None]) ** 2)
                  / (0.03 * h * w)).astype(np.float32)


def _opt_inputs():
    return dict(density=_blob(np.random.default_rng(0), 2, 16, 16),
                target=_blob(np.random.default_rng(5), 2, 16, 16))


def _indirect_inputs():
    b, h = 4, 16
    plate = np.zeros((h, h), np.float32)
    plate[7:9, 4:12] = 1.0
    return dict(density=_blob(np.random.default_rng(0), b, h, h),
                inflow=0.05 * _blob(np.random.default_rng(3), b, h, h),
                target=_blob(np.random.default_rng(7), b, h, h),
                bf=np.full((b, 1, 1), 0.15, np.float32), plate=plate)


def _diag_inputs():
    h = 64
    plate = np.zeros((h, h), np.float32)
    plate[h // 2, h // 4:h // 2] = 1.0
    return dict(plate=plate, div=np.random.default_rng(0).normal(
        0, 1, (2, h, h)).astype(np.float32))


def _jax_opt(x):
    domain = JDomain.create(16, 16)
    cfg = JConfig(dt=0.5, buoyancy=0.0, pressure_tol=1e-5,
                  pressure_maxiter=200, pressure_backend="spectral")
    state0 = JState(velocity=JStaggered.zeros(2, 16, 16),
                    density=jnp.asarray(x["density"]))
    forces, hist = optimize_forces_spatial(
        state0, jnp.asarray(x["target"]), domain, cfg, make_mesh2d(1, 2),
        **OPT)
    return dict({k: np.asarray(hist[k]) for k in
                 ("total", "obs_loss", "force_cost")},
                fvy=np.asarray(forces.vy), fvx=np.asarray(forces.vx))


def _jax_indirect(x):
    domain = JDomain.create(16, 16, obstacle_mask=jnp.asarray(x["plate"]))
    cfg = JConfig(dt=0.5, buoyancy=0.1, pressure_tol=1e-7,
                  pressure_maxiter=800, pressure_backend="pcg")
    mesh = make_mesh2d(2, 2)
    state0 = JState(velocity=JStaggered.zeros(4, 16, 16),
                    density=jnp.asarray(x["density"]),
                    inflow=jnp.asarray(x["inflow"]),
                    pressure=jnp.zeros((4, 16, 16), jnp.float32))
    target = jnp.asarray(x["target"])

    def loss_fn(bf):
        def body(s, _):
            return spatial_fluid_step(s, domain, cfg, mesh,
                                      buoyancy_factor=bf), None

        final, _ = lax.scan(body, state0, None, length=2)
        return jnp.mean((final.density - target) ** 2)

    loss, g = jax.jit(jax.value_and_grad(loss_fn))(jnp.asarray(x["bf"]))
    return dict(loss=float(loss), gbf=np.asarray(g))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_opt")
    opt, ind, diag = _opt_inputs(), _indirect_inputs(), _diag_inputs()
    handles = [td.start_ranks(td.spatial_opt, world, tmp / f"w{world}", opt,
                              OPT, ind, diag) for world in (2, 4)]
    refs = {"opt": _jax_opt(opt), "indirect": _jax_indirect(ind)}
    got = [td.join_ranks(h)[0] for h in handles]
    return refs, {"(1, 2)": got[0], "(2, 2)": got[1]}


WORLDS = ["(1, 2)", "(2, 2)"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["total", "obs_loss", "force_cost"])
def test_adjoint_history_matches_jax(runs, key, world):
    refs, got = runs
    np.testing.assert_allclose(got[world]["opt"][key], refs["opt"][key],
                               rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["fvy", "fvx"])
def test_adjoint_forces_match_jax(runs, key, world):
    refs, got = runs
    ref = refs["opt"][key]
    assert np.abs(ref).max() > 1e-3
    err = np.linalg.norm(got[world]["opt"][key] - ref) / np.linalg.norm(ref)
    assert err < 1e-4, err


@pytest.mark.parametrize("world", WORLDS)
def test_adjoint_loss_falls(runs, world):
    obs = runs[1][world]["opt"]["obs_loss"]
    assert np.all(np.isfinite(obs)), obs
    assert obs[-1] < obs[0] * 0.9, obs


def test_indirect_inflow_warm_start_matches_jax(runs):
    refs, got = runs
    r = got["(2, 2)"]["indirect"]
    np.testing.assert_allclose(r["loss"], refs["indirect"]["loss"],
                               rtol=1e-5)
    assert np.abs(refs["indirect"]["gbf"]).max() > 1e-5
    np.testing.assert_allclose(r["gbf"], refs["indirect"]["gbf"],
                               rtol=G_RTOL, atol=G_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_two_level_solve_agrees_with_fewer_trips(runs, world):
    r = runs[1][world]
    np.testing.assert_allclose(r["diag_pcg2"]["p"], r["diag_pcg"]["p"],
                               rtol=1e-3, atol=1e-4)
    assert 0 < r["diag_pcg2"]["trips"] < r["diag_pcg"]["trips"], (
        r["diag_pcg"]["trips"], r["diag_pcg2"]["trips"])
