"""The JAX package's draws of the out-of-distribution evals' sets, on the
CPU: `tests/goldens/jax_draws_ood_shapes.npz` (`generalize_shapes`: the
`shapes`, `crosses` and `rings` families at seeds 999, 1999 and 2999) and
`jax_draws_ood_smoke.npz` (`generalize_smoke`: `in_dist`, `obstacles_ood`,
`inflow_shifted`, `horizon_24` and `horizon_32` at 999, 1999, 2999, 4023
and 4031), written by `scripts/make_jax_draws.py`.

* The first chunk of each case, fed through the port's `*_from_draws`,
  is what the JAX generators give at the case's seed, within 1e-6: the
  families' densities and the two force fields (amplitude 0.1) of
  `generate_forced_smoke_dataset`; the sources (the case's
  `inflow_kwargs`) and the buoyancy field (amplitude 16 / horizon) of
  `generate_inflow_smoke_dataset`. `shapes` is config 3's validation
  set, and its arrays are `jax_draws_config3.npz`'s `val` split.
* `inflow_shifted`'s first chunk rolled out by the port's generator on
  the draws' pops (`quality_torch.patch_draws`), 8 warm-up steps and 4
  recorded on config 4's domain and physics, forced and with zero force,
  against the JAX package's generator at seed 2999: the densities within
  1e-5 of their max, and the zero-force final MSE (the eval's zero-force
  column at that horizon) within 1e-5 relative.

Budget: ~30 s of one worker, most of it the JAX rollouts' compiles.
"""

from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import torch

import jax

from pde_control_tpu.data import generate as jgen
from pde_control_tpu.experiments.fluid2d import (
    default_obstacles as jdefault_obstacles,
)
from pde_control_tpu.grids import Domain2D as JDomain2D
from pde_control_tpu.physics.fluid import FluidConfig as JFluidConfig
from pde_control_tpu_torch.data import generate
from pde_control_tpu_torch.experiments.fluid2d import default_obstacles
from pde_control_tpu_torch.grids import Domain2D
from pde_control_tpu_torch.physics.fluid import FluidConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
GOLDENS = ROOT / "tests" / "goldens"
_spec = importlib.util.spec_from_file_location(
    "quality_torch", ROOT / "scripts" / "quality_torch.py")
quality = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(quality)

JAX_FAMILIES = {"shapes": jgen.random_shape_densities,
                "crosses": jgen.random_cross_densities,
                "rings": jgen.random_ring_densities}


def _load(name: str):
    z = np.load(GOLDENS / f"jax_draws_{name}.npz")
    return z, json.loads(str(z["config"]))


def _first(z, split: str, keys: tuple, i: int = 0) -> tuple:
    return tuple(torch.from_numpy(np.array(z[f"{split}/{k}"][i])) for k in keys)


def _close(got: torch.Tensor, want, label: str) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6, err_msg=label)


def test_ood_shapes_draws_are_the_jax_generators():
    """`generate_forced_smoke_dataset(init=<family>)`'s first chunk of each
    case: `key, k1, k2, k3 = split(key, 4)`, k1 the family, k2 and k3 the
    forces fy and fx."""
    z, meta = _load("ood_shapes")
    assert (meta["size"], meta["chunk"]) == (64, 8)
    assert {s: (v["seed"], v["num"], v["init"], v["kinds"])
            for s, v in meta["splits"].items()} == {
        f: (seed, 32, f, [f, "field"])
        for f, seed in (("shapes", 999), ("crosses", 1999), ("rings", 2999))}
    with np.load(GOLDENS / "jax_draws_config3.npz") as c3:
        val = {k.split("/")[1]: c3[k] for k in c3.files if k.startswith("val/")}
    assert {k: z[f"shapes/{k}"].tobytes() for k in val} == {
        k: v.tobytes() for k, v in val.items()}
    for family, v in meta["splits"].items():
        keys = quality.DRAW_KEYS[family]
        assert z[f"{family}/{keys[0]}"].shape == (4, 8, 2)
        assert z[f"{family}/amps"].shape == (8, 8, 3, 3)
        _, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(v["seed"]), 4)
        _close(generate.INITS[family][1](*_first(z, family, keys), 64, 64),
               JAX_FAMILIES[family](k1, 8, 64, 64), family)
        for i, k in enumerate((k2, k3)):
            _close(generate.smooth_field_from_draws(
                *_first(z, family, ("amps", "phy", "phx"), i), 64, 64,
                amplitude=0.1),
                jgen.random_smooth_field_2d(k, 8, 64, 64, amplitude=0.1),
                f"{family} field {i}")


def test_ood_smoke_draws_are_the_jax_generators():
    """`generate_inflow_smoke_dataset`'s first chunk of each case: `key,
    k1, k2 = split(key, 3)`, k1 the sources, k2 the buoyancy field."""
    z, meta = _load("ood_smoke")
    assert (meta["size"], meta["chunk"]) == (64, 8)
    assert {s: (v["seed"], v["num"]) for s, v in meta["splits"].items()} == {
        "in_dist": (999, 32), "obstacles_ood": (1999, 32),
        "inflow_shifted": (2999, 32), "horizon_24": (4023, 32),
        "horizon_32": (4031, 32)}
    assert meta["splits"]["inflow_shifted"]["inflow_kwargs"] == {
        "y0": 10.0, "x_range": [0.05, 0.3]}
    assert [meta["splits"][f"horizon_{n}"]["horizon"] for n in (24, 32)] == [
        24, 32]
    for case, v in meta["splits"].items():
        assert v["kinds"] == ["inflow", "field"]
        assert z[f"{case}/xs"].shape == (4, 8, 1, 1)
        kw = dict(v.get("inflow_kwargs", {}))
        if "x_range" in kw:
            kw["x_range"] = tuple(kw["x_range"])
        amplitude = 16 / v.get("horizon", 16)
        _, k1, k2 = jax.random.split(jax.random.PRNGKey(v["seed"]), 3)
        (xs,) = _first(z, case, ("xs",))
        _close(generate.inflow_from_draws(xs, 64, 64, y0=kw.get("y0", 4.0)),
               jgen.random_inflow(k1, 8, 64, 64, **kw), f"{case} inflow")
        _close(generate.smooth_field_from_draws(
            *_first(z, case, ("amps", "phy", "phx")), 64, 64,
            amplitude=amplitude),
            jgen.random_smooth_field_2d(k2, 8, 64, 64, amplitude=amplitude),
            f"{case} field")


def test_inflow_shifted_rollout_and_zero_force_match_jax():
    kw = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-4, pressure_maxiter=200,
              warm_start_pressure=True)
    inflow = dict(y0=10.0, x_range=(0.05, 0.30))
    domain = Domain2D.create(64, 64, obstacle_mask=default_obstacles(64, 64),
                             device="cpu")
    jdomain = JDomain2D.create(64, 64, obstacle_mask=jax.numpy.asarray(
        jdefault_obstacles(64, 64)))
    got, want = {}, {}
    with quality.patch_draws("ood_smoke") as (pops, _):
        for amp in (1.0, 0.0):
            got[amp] = generate.generate_inflow_smoke_dataset(
                domain, FluidConfig(**kw), 8, 4, seed=2999,
                control_amplitude=amp, inflow_kwargs=inflow).obs
    assert pops == {("inflow_shifted", "inflow"): 2,
                    ("inflow_shifted", "field"): 2}
    for amp in (1.0, 0.0):
        want[amp] = jgen.generate_inflow_smoke_dataset(
            jdomain, JFluidConfig(**kw), 8, 4, seed=2999,
            control_amplitude=amp, inflow_kwargs=inflow).obs
        assert got[amp].shape == want[amp].shape == (8, 5, 64, 64, 1)
        err = np.abs(got[amp] - want[amp]).max() / np.abs(want[amp]).max()
        assert err <= 1e-5, (amp, err)
    zero = {k: float(np.mean((d[0.0][:, 4] - d[1.0][:, 4]) ** 2))
            for k, d in (("port", got), ("jax", want))}
    assert zero["jax"] > 0
    assert abs(zero["port"] - zero["jax"]) <= 1e-5 * zero["jax"], zero
