"""The data of BASELINE configs 3 and 5 against the JAX package's, on the
CPU: the blob and shape generators, the natural and forced smoke datasets,
and the two configs' disk-cache keys.

Held to:
* each construction (`*_from_draws`) fed the draws `jax.random` makes for
  the JAX package's key equals the JAX generator's output within 1e-6
  (16², batch 4, so that the margins clamp to h // 4);
* `generate_forced_smoke_dataset` (init 'shapes' with config 3's physics,
  'blobs' with config 5's) and `generate_smoke_dataset` with their draws
  replaced by the JAX package's: the trajectories within rtol 1e-5 /
  atol 1e-6 of the JAX package's at 16², n=4, pressure tol 1e-6 (the
  generator rollout's tolerance in `tests/test_torch_data.py`);
* `_shape_transition_setup` and `_natural_flow_setup` ask the disk cache
  for the JAX package's keys (exact), and the datasets they return are
  the generators' at the configs' seeds; with `pressure_backend='cuda'`
  the data is within 1e-3 of the exact solve's and the fused step runs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu.data import generate as jgen
from pde_control_tpu.experiments import fluid2d as jfluid2d
from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.physics.fluid import FluidConfig as JConfig
from pde_control_tpu_torch.data import generate
from pde_control_tpu_torch.experiments import fluid2d
from pde_control_tpu_torch.grids import Domain2D
from pde_control_tpu_torch.physics.fluid import FluidConfig

torch.set_num_threads(1)

H, B = 16, 4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _pos(key, margin, shape):
    hi = jnp.array([H - margin, H - margin], jnp.float32)
    return jax.random.uniform(key, shape, minval=float(margin),
                              maxval=hi.reshape((1, 2) + (1,) * (len(shape) - 2)))


def _jax_draws(init: str, key, batch: int = B):
    """The draws the JAX package's `init` generator makes from `key`, in
    the port's `*_draws` layout (centres (B, 2))."""
    m = min(12, H // 4)
    if init == "blobs":
        k_pos, k_sig = jax.random.split(key)
        pos = _pos(k_pos, min(8, H // 4), (batch, 2))
        return pos, jax.random.uniform(k_sig, (batch, 1, 1), minval=4.0,
                                       maxval=8.0)
    if init == "shapes":
        k_pos, k_size, k_kind, k_ar = jax.random.split(key, 4)
        return (_pos(k_pos, m, (batch, 2, 1, 1)).reshape(batch, 2),
                jax.random.uniform(k_size, (batch, 1, 1), minval=5.0,
                                   maxval=10.0),
                jax.random.uniform(k_ar, (batch, 1, 1), minval=0.6,
                                   maxval=1.6),
                jax.random.bernoulli(k_kind, 0.5, (batch, 1, 1)))
    k_pos, k_size, k_frac = jax.random.split(key, 3)
    lo, hi, flo, fhi = ((5.0, 10.0, 0.25, 0.45) if init == "crosses"
                        else (6.0, 10.0, 0.4, 0.65))
    return (_pos(k_pos, m, (batch, 2, 1, 1)).reshape(batch, 2),
            jax.random.uniform(k_size, (batch, 1, 1), minval=lo, maxval=hi),
            jax.random.uniform(k_frac, (batch, 1, 1), minval=flo, maxval=fhi))


_JAX_INITS = {"shapes": jgen.random_shape_densities,
              "blobs": jgen.random_smoke_blobs,
              "crosses": jgen.random_cross_densities,
              "rings": jgen.random_ring_densities}


@pytest.mark.parametrize("init", sorted(_JAX_INITS))
def test_construction_from_jax_draws_matches_jax(init):
    key = jax.random.PRNGKey(5)
    _, build = generate.INITS[init]
    got = build(*(_t(d) for d in _jax_draws(init, key)), H, H)
    want = np.asarray(_JAX_INITS[init](key, B, H, H))
    assert got.shape == (B, H, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert float(got.max()) > 0.5  # every family puts density on the grid


def test_port_draws_are_seeded_and_in_range():
    for init, (draw, build) in generate.INITS.items():
        a = build(*draw(torch.Generator().manual_seed(2), 64, H, H), H, H)
        b = build(*draw(torch.Generator().manual_seed(2), 64, H, H), H, H)
        assert torch.equal(a, b), init
        assert float(a.min()) >= 0 and float(a.max()) <= 1, init
        pos = draw(torch.Generator().manual_seed(2), 64, H, H)[0]
        assert float(pos.min()) >= 4 and float(pos.max()) <= H - 4, init
    kinds = generate.shape_draws(torch.Generator().manual_seed(0), 64, H, H)[3]
    assert 0 < int(kinds.sum()) < 64  # circles and boxes both drawn


_PHYSICS = {"shapes": dict(dt=1.0, buoyancy=0.0, amplitude=0.1),
            "blobs": dict(dt=0.5, buoyancy=0.05, amplitude=0.05),
            "natural": dict(dt=1.0, buoyancy=0.08, amplitude=None)}


@pytest.mark.parametrize("case", sorted(_PHYSICS))
def test_dataset_from_jax_draws_matches_jax(case, monkeypatch):
    """The port's dataset functions, their draws replaced by the JAX
    package's for its seed, against the JAX package's datasets."""
    phys = dict(_PHYSICS[case])
    amplitude = phys.pop("amplitude")
    kw = dict(pressure_tol=1e-6, pressure_maxiter=500,
              warm_start_pressure=True, **phys)
    num, n, seed = 3, 4, 11
    jdom, dom = JDomain.create(H, H), Domain2D.create(H, H, device="cpu")
    key = jax.random.PRNGKey(seed)
    if case == "natural":
        key, k = jax.random.split(key)
        init_draws, field_draws = _jax_draws("blobs", k, num), []
        want = jgen.generate_smoke_dataset(jdom, JConfig(**kw), num, n,
                                           seed=seed)
    else:
        key, k1, k2, k3 = jax.random.split(key, 4)
        init_draws = _jax_draws(case, k1, num)
        field_draws = []
        for k in (k2, k3):
            k_amp, k_phy, k_phx = jax.random.split(k, 3)
            field_draws.append((
                jax.random.normal(k_amp, (num, 3, 3)),
                jax.random.uniform(k_phy, (num, 3, 1), maxval=2 * jnp.pi),
                jax.random.uniform(k_phx, (num, 3, 1), maxval=2 * jnp.pi)))
        want = jgen.generate_forced_smoke_dataset(
            jdom, JConfig(**kw), num, n, seed=seed, init=case,
            force_amplitude=amplitude)
    init = "blobs" if case == "natural" else case
    fields = iter(field_draws)
    monkeypatch.setitem(generate.INITS, init, (
        lambda gen, b, h, w: tuple(_t(d) for d in init_draws),
        generate.INITS[init][1]))
    monkeypatch.setattr(generate, "smooth_field_draws",
                        lambda gen, b: tuple(_t(d) for d in next(fields)))
    if case == "natural":
        got = generate.generate_smoke_dataset(dom, FluidConfig(**kw), num, n,
                                              seed=seed)
    else:
        got = generate.generate_forced_smoke_dataset(
            dom, FluidConfig(**kw), num, n, seed=seed, init=case,
            force_amplitude=amplitude)
    assert got.obs.shape == want.obs.shape == (num, n + 1, H, H, 1)
    np.testing.assert_allclose(got.obs, want.obs, rtol=1e-5, atol=1e-6)
    assert set(got.extras) == set(want.extras) == {"vy0", "vx0"}
    for k in got.extras:
        np.testing.assert_array_equal(got.extras[k], want.extras[k])
    # The flow moved the density: frame n is not frame 0.
    assert np.abs(got.obs[:, n] - got.obs[:, 0]).max() > 1e-3


def _cache_requests(module, setup, monkeypatch, **kw):
    """The (split, key) pairs `setup` asks the disk cache for, and the
    build functions it would call on a miss."""
    asked = []

    def cached(datadir, split, params, build):
        asked.append((split, params, build))
        return None

    monkeypatch.setattr(module, "_maybe_cached", cached)
    getattr(module, setup)(64, 16, 8, 4, "unused", **kw)
    return asked


@pytest.mark.parametrize("setup", ["_shape_transition_setup",
                                   "_natural_flow_setup"])
def test_cache_keys_match_jax(setup, monkeypatch):
    got = _cache_requests(fluid2d, setup, monkeypatch, device="cpu",
                          fused="cuda", conv_impl="cuda")
    want = _cache_requests(jfluid2d, setup, monkeypatch)
    assert [(s, k) for s, k, _ in got] == [(s, k) for s, k, _ in want]
    assert [k["seed"] for _, k, _ in got] == [0, 999]
    assert [k["num"] for _, k, _ in got] == [8, 4]


def test_setups_generate_the_configs_data():
    """Config 3's and 5's setups on a small grid: the datasets are the
    generators' at seeds 0 and 999, and the PDE takes the training routes
    while the data keeps the default one."""
    pde, train, val = fluid2d._shape_transition_setup(
        8, 2, 3, 2, None, device="cpu", fused="cuda", conv_impl="cuda")
    want = generate.generate_forced_smoke_dataset(
        Domain2D.create(8, 8, device="cpu"), fluid2d._shape_transition_cfg(),
        3, 2, seed=0, init="shapes")
    np.testing.assert_array_equal(train.obs, want.obs)
    assert val.obs.shape == (2, 3, 8, 8, 1)
    assert (pde.control, pde.cfg.fused, pde.conv_impl, pde.unet_levels) == (
        "direct", "cuda", "cuda", 2)
    pde5, train5, _ = fluid2d._natural_flow_setup(8, 2, 2, 2, None,
                                                  device="cpu")
    assert (pde5.cfg.dt, pde5.cfg.buoyancy, pde5.unet_levels) == (0.5, 0.05, 3)
    assert np.isfinite(train5.obs).all() and train5.obs.shape == (2, 3, 8, 8, 1)


def test_kernel_pressure_route_for_the_empty_box():
    """In configs 3's and 5's empty closed box the default route solves the
    pressure exactly and the fused step refuses; pressure_backend='cuda'
    (K1, tol-bounded PCG; its plain version here) generates data within
    the solve's tolerance of the exact one and lets the fused step run."""
    exact = fluid2d._shape_transition_setup(H, 2, 3, 2, None, device="cpu",
                                            fused="cuda")
    pcg = fluid2d._shape_transition_setup(H, 2, 3, 2, None, device="cpu",
                                          fused="cuda", pressure_backend="cuda")
    np.testing.assert_allclose(pcg[1].obs, exact[1].obs, rtol=0, atol=1e-3)
    assert not np.array_equal(pcg[1].obs, exact[1].obs)
    for (pde, train, _), ok in ((exact, False), (pcg, True)):
        batch = {k: torch.from_numpy(v) for k, v in train.take([0, 1]).items()}
        state = pde.initial_state(batch)
        force = pde.zero_force(state)
        if ok:
            assert torch.isfinite(pde.step(state, force).density).all()
        else:
            with pytest.raises(ValueError, match="spectral"):
                pde.step(state, force)
