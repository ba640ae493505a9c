"""The port's geometry, dataset generation and scene trees against the JAX
package's, on the CPU.

Held to:
* geometry: `default_obstacles` at 16² and 64², and `rasterize` of a box,
  a sphere and a union with and without `smooth`, equal to the JAX
  package's (exact);
* random fields: `random_smooth_field_2d` and `random_inflow` built by
  the port from the draws `jax.random` makes for the JAX package's key
  equal its output within 1e-6;
* the generator's rollout (16², 8 warm-up steps, 4 forced steps, pressure
  tol 1e-6): given the same inflow and b field, obs, vy0 and vx0 against
  a rollout assembled from the JAX package's `fluid_step` within rtol
  1e-5 / atol 1e-6;
* scene trees: a tree written by either package's `save_dataset` loads
  bit for bit in the other; `load_or_generate` hits on the same key and
  regenerates on a changed one; the task's cache key is the JAX
  package's;
* sampling: `DeviceDataset.sample`, `take` and `sample_stacked` draw the
  same indices as the JAX package's for the same `Generator` state
  (exact).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu import geom as jgeom
from pde_control_tpu.data import generate as jgen
from pde_control_tpu.data import scene as jscene
from pde_control_tpu.experiments import fluid2d as jfluid2d
from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.grids import Staggered2D as JStaggered
from pde_control_tpu.grids import centered_to_y_faces as j_to_y_faces
from pde_control_tpu.physics.fluid import FluidConfig as JConfig
from pde_control_tpu.physics.fluid import FluidState as JState
from pde_control_tpu.physics.fluid import fluid_step as j_fluid_step
from pde_control_tpu_torch import geom
from pde_control_tpu_torch.data import generate, scene
from pde_control_tpu_torch.experiments import fluid2d
from pde_control_tpu_torch.grids import Domain2D
from pde_control_tpu_torch.physics.fluid import FluidConfig

torch.set_num_threads(1)

H = 16


# ---------------------------------------------------------------- geometry

@pytest.mark.parametrize("size", [16, 64])
def test_default_obstacles_match_jax(size):
    got = fluid2d.default_obstacles(size, size)
    want = jfluid2d.default_obstacles(size, size)
    assert got.dtype == np.float32 and got.shape == (size, size)
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


_SHAPES = {
    "box": (geom.Box(3.5, 2.0, 7.2, 11.0), jgeom.Box(3.5, 2.0, 7.2, 11.0)),
    "sphere": (geom.Sphere(8.0, 6.5, 4.3), jgeom.Sphere(8.0, 6.5, 4.3)),
    "union": (geom.union(geom.Box(1.0, 1.0, 4.0, 9.0),
                         geom.Sphere(10.0, 10.0, 3.0)),
              jgeom.union(jgeom.Box(1.0, 1.0, 4.0, 9.0),
                          jgeom.Sphere(10.0, 10.0, 3.0))),
}


@pytest.mark.parametrize("smooth", [0.0, 1.5])
@pytest.mark.parametrize("name", sorted(_SHAPES))
def test_rasterize_matches_jax(name, smooth):
    t, j = _SHAPES[name]
    got = geom.rasterize(t, H, H + 3, smooth=smooth, device="cpu").numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jgeom.rasterize(j, H, H + 3, smooth=smooth)))
    np.testing.assert_array_equal(
        geom.sdf_grid(t, H, H + 3, device="cpu").numpy(),
        np.asarray(jgeom.sdf_grid(j, H, H + 3)))


# ------------------------------------------------------------ random fields

def test_smooth_field_from_jax_draws_matches_jax():
    key = jax.random.PRNGKey(7)
    b, modes, amplitude = 3, 3, 0.6
    k_amp, k_phy, k_phx = jax.random.split(key, 3)
    amps = jax.random.normal(k_amp, (b, modes, modes))
    phy = jax.random.uniform(k_phy, (b, modes, 1), maxval=2 * jnp.pi)
    phx = jax.random.uniform(k_phx, (b, modes, 1), maxval=2 * jnp.pi)
    got = generate.smooth_field_from_draws(
        *(torch.from_numpy(np.array(a)) for a in (amps, phy, phx)),
        H, H + 4, amplitude=amplitude)
    want = jgen.random_smooth_field_2d(key, b, H, H + 4, modes=modes,
                                       amplitude=amplitude)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_inflow_from_jax_draws_matches_jax():
    key = jax.random.PRNGKey(11)
    b, w = 4, H + 2
    xs = jax.random.uniform(key, (b, 1, 1), minval=0.15 * w, maxval=0.85 * w)
    got = generate.inflow_from_draws(torch.from_numpy(np.array(xs)), H, w)
    want = jgen.random_inflow(key, b, H, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_port_draws_are_seeded_and_in_range():
    a = generate.random_inflow(torch.Generator().manual_seed(3), 5, H, H)
    b = generate.random_inflow(torch.Generator().manual_seed(3), 5, H, H)
    assert torch.equal(a, b) and a.shape == (5, H, H)
    xs = generate.inflow_draws(torch.Generator().manual_seed(3), 100, H)
    assert float(xs.min()) >= 0.15 * H and float(xs.max()) <= 0.85 * H


# ------------------------------------------------------- generator rollout

_GEN_CFG = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-6,
                pressure_maxiter=500, warm_start_pressure=True)


def test_generator_rollout_matches_jax_fluid_step():
    obstacles = fluid2d.default_obstacles(H, H)
    rng = np.random.default_rng(0)
    inflow = generate.random_inflow(torch.Generator().manual_seed(1), 2, H, H)
    b_field = torch.from_numpy(
        rng.normal(size=(2, H, H)).astype(np.float32) * 0.6)
    n, warmup = 4, 8
    dom = Domain2D.create(H, H, obstacle_mask=obstacles, device="cpu")
    traj, vel0 = generate.inflow_smoke_rollout(
        dom, FluidConfig(**_GEN_CFG), inflow, b_field, n, warmup)

    jdom = JDomain.create(H, H, obstacle_mask=jnp.asarray(obstacles))
    jcfg = JConfig(**_GEN_CFG)
    step = jax.jit(lambda s, f: j_fluid_step(s, jdom, jcfg, force=f))
    jb = jnp.asarray(b_field.numpy())
    s = JState(velocity=JStaggered.zeros(2, H, H),
               density=jnp.zeros((2, H, H)), inflow=jnp.asarray(inflow.numpy()))
    for _ in range(warmup):
        s = step(s, None)
    frames, jvel0 = [s.density], s.velocity
    for _ in range(n):
        s = step(s, JStaggered(vy=j_to_y_faces(jb * s.density),
                               vx=jnp.zeros_like(s.velocity.vx)))
        frames.append(s.density)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(traj.numpy(), np.stack(frames), **tol)
    np.testing.assert_allclose(vel0.vy.numpy(), np.asarray(jvel0.vy), **tol)
    np.testing.assert_allclose(vel0.vx.numpy(), np.asarray(jvel0.vx), **tol)
    assert float(traj[-1].sum()) > float(traj[0].sum()) > 0  # sources on


def test_generate_dataset_layout():
    dom = Domain2D.create(8, 8, device="cpu")
    cfg = FluidConfig(dt=1.0, buoyancy=0.08, pressure_backend="pcg",
                      pressure_tol=1e-4, pressure_maxiter=50)
    ds = generate.generate_inflow_smoke_dataset(dom, cfg, 3, 2, seed=5,
                                                batch=2, warmup=1)
    again = generate.generate_inflow_smoke_dataset(dom, cfg, 3, 2, seed=5,
                                                   batch=2, warmup=1)
    assert ds.obs.shape == (3, 3, 8, 8, 1) and ds.obs.dtype == np.float32
    assert {k: v.shape for k, v in ds.extras.items()} == {
        "vy0": (3, 9, 8), "vx0": (3, 8, 9), "inflow": (3, 8, 8)}
    np.testing.assert_array_equal(ds.obs, again.obs)
    assert np.isfinite(ds.obs).all()


# -------------------------------------------------------------- scene trees

def _dataset(num=5, t=3, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(obs=f(num, t, H, H, 1), vy0=f(num, H + 1, H),
                vx0=f(num, H, H + 1), inflow=f(num, H, H))


@pytest.mark.parametrize("fmt", ["npy", "npz"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_scene_tree_loads_in_the_other_package(tmp_path, writer, fmt):
    arrays = _dataset()
    obs = arrays.pop("obs")
    root = str(tmp_path / "tree")
    if writer == "jax":
        jscene.save_dataset(root, jscene.TrajectoryDataset(obs, **arrays),
                            fmt=fmt)
        got = scene.load_dataset(root, 5, 3, extras=sorted(arrays))
    else:
        scene.save_dataset(root, scene.TrajectoryDataset(obs, **arrays),
                           fmt=fmt)
        got = jscene.load_dataset(root, 5, 3, extras=sorted(arrays))
    assert sorted(os.listdir(root)) == [f"sim_{i:06d}" for i in range(5)]
    np.testing.assert_array_equal(got.obs, obs)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got.extras[k], v)


def test_load_or_generate_hits_and_regenerates(tmp_path):
    root = str(tmp_path / "cache")
    calls = []

    def build(seed):
        calls.append(seed)
        arrays = _dataset(num=2, seed=seed)
        return scene.TrajectoryDataset(arrays.pop("obs"), **arrays)

    first = scene.load_or_generate(root, {"seed": 0}, lambda: build(0))
    hit = scene.load_or_generate(root, {"seed": 0}, lambda: build(0))
    # The JAX package reads the port's cache as a hit too.
    jhit = jscene.load_or_generate(root, {"seed": 0}, lambda: build(9))
    assert calls == [0]
    for ds in (hit, jhit):
        np.testing.assert_array_equal(ds.obs, first.obs)
        np.testing.assert_array_equal(ds.extras["inflow"],
                                      first.extras["inflow"])
    changed = scene.load_or_generate(root, {"seed": 1}, lambda: build(1))
    assert calls == [0, 1]
    assert not np.array_equal(changed.obs, first.obs)
    with open(os.path.join(root, "manifest.json")) as f:
        assert json.load(f)["extras"] == ["inflow", "vx0", "vy0"]


def test_physics_cache_key_matches_jax():
    kw = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-4, pressure_maxiter=200,
              warm_start_pressure=True)
    assert (fluid2d._physics_key(FluidConfig(**kw, fused="cuda"))
            == jfluid2d._physics_key(JConfig(**kw)))


def test_concat_datasets_and_slice():
    a, b = _dataset(num=2, seed=1), _dataset(num=3, seed=2)
    da = scene.TrajectoryDataset(a.pop("obs"), **a)
    db = scene.TrajectoryDataset(b.pop("obs"), **b)
    cat = scene.concat_datasets(da, db)
    assert len(cat) == 5
    np.testing.assert_array_equal(cat.slice(2, 5).obs, db.obs)
    with pytest.raises(ValueError, match="extras mismatch"):
        scene.concat_datasets(da, scene.TrajectoryDataset(db.obs))


# ----------------------------------------------------------------- sampling

def test_device_dataset_draws_match_jax():
    arrays = _dataset(num=7)
    obs = arrays.pop("obs")
    host = scene.TrajectoryDataset(obs, **arrays)
    dev = scene.DeviceDataset.wrap(host, "cpu")
    assert scene.DeviceDataset.wrap(host, "cpu") is dev  # cached view
    jdev = jscene.DeviceDataset.wrap(jscene.TrajectoryDataset(obs, **arrays))
    r_t, r_j = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(2):
        for got, want in ((dev.sample(r_t, 3), jdev.sample(r_j, 3)),
                          (dev.sample_stacked(r_t, 2, 3),
                           jdev.sample_stacked(r_j, 2, 3)),
                          (dev.take(np.array([6, 0, 2])),
                           jdev.take(np.array([6, 0, 2])))):
            assert set(got) == set(want)
            for k in got:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
    assert dev.sample_stacked(r_t, 2, 3)["obs"].shape == (2, 3, 3, H, H, 1)


def test_device_dataset_fp16_store_returns_fp32():
    arrays = _dataset(num=3)
    ds = scene.DeviceDataset(arrays.pop("obs"), store_dtype=np.float16,
                             device="cpu", **arrays)
    got = ds.take(np.array([1]))
    assert ds.obs.dtype == torch.float16 and got["obs"].dtype == torch.float32
