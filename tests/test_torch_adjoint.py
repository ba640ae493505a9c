"""The adjoint baseline and the scheme comparison against the JAX package,
on the CPU.

Held to:
* `optimize_forces` on Burgers (N=32, B=4, n=4, 5 iterations, lr 0.1,
  with the default clip 1.0 and without): the history (`total`,
  `obs_loss`, `force_cost`) at rtol 1e-4, the fp32 loss tolerance of
  `tests/test_torch_control.py`, and the optimized forces within 1e-5 of
  the JAX package's (five Adam steps of at most lr each);
* `optimize_forces` on a 16² fluid with a plate and inflow (n=2, 3
  iterations, the full staggered force, pressure tol 1e-6): the same
  tolerances;
* a second call of the same shape reuses the cached program, reset in
  place: another batch's result equals a fresh PDE's exactly;
* `force_abs_mean` of a tensor force (Burgers) and of a staggered one, and
  `curriculum._force_at` of both, against the JAX package's within 1e-6;
* the CLI's `burgers_adjoint` and `compare_burgers` with `--smoke-test
  --device cpu`: the JAX package's result keys, and every row of
  `comparison.json` (`chain_final`, `staggered`, `refined`, `adjoint`,
  `zero_force`);
* `run_comparison` on a 16² smoke setup (a plate, inflow, n=4) with
  `adjoint_iterations=3` in microbatches of 2: every row, and a resumed
  run that trains nothing and returns the same rows.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pde_control_tpu.control.adjoint import optimize_forces as joptimize
from pde_control_tpu.control.pde_burgers import BurgersPDE as JBurgers
from pde_control_tpu.control.pde_fluid import IncompressibleFluidPDE as JFluid
from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.grids import Staggered2D as JStaggered
from pde_control_tpu.physics.burgers import BurgersConfig as JBConfig
from pde_control_tpu.physics.fluid import FluidConfig as JFConfig
from pde_control_tpu_torch import (
    ControlTraining,
    Domain2D,
    FluidConfig,
    IncompressibleFluidPDE,
    Staggered2D,
)
from pde_control_tpu_torch.control.adjoint import optimize_forces
from pde_control_tpu_torch.control.pde_burgers import BurgersPDE
from pde_control_tpu_torch.experiments import compare_schemes, curriculum, run
from pde_control_tpu_torch.experiments.fluid2d import default_obstacles
from pde_control_tpu_torch.physics.burgers import BurgersConfig

torch.set_num_threads(1)

N, B = 32, 4
_BCFG = dict(n=N, dx=1.0 / N, dt=0.03, viscosity=0.01)
H = 16
_FCFG = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-6, pressure_maxiter=500,
             warm_start_pressure=True)
_KEYS = ("total", "obs_loss", "force_cost")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _burgers_batch(n, seed):
    rng = np.random.default_rng(seed)
    x = np.arange(N) * (2 * np.pi / N)
    obs = np.stack([np.sin(x + p) * a for a, p in
                    rng.uniform(0.3, 1.0, size=(B * (n + 1), 2))])
    return obs.reshape(B, n + 1, N, 1).astype(np.float32)


def _assert_history(hist, jhist):
    for k in _KEYS:
        assert hist[k].shape == np.asarray(jhist[k]).shape
        np.testing.assert_allclose(hist[k], np.asarray(jhist[k]), rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("clip", [1.0, None])
def test_optimize_forces_on_burgers_matches_jax(clip):
    n, it = 4, 5
    obs = _burgers_batch(n, 0)
    jpde = JBurgers(JBConfig(**_BCFG))
    jf, jh = joptimize(jpde, jnp.asarray(obs[:, 0, :, 0]),
                       jnp.asarray(obs[:, n]), n=n, iterations=it,
                       learning_rate=0.1, force_reg=1e-4, grad_clip=clip)
    pde = BurgersPDE(BurgersConfig(**_BCFG), device="cpu")
    f, h = optimize_forces(pde, _t(obs[:, 0, :, 0]), _t(obs[:, n]), n=n,
                           iterations=it, learning_rate=0.1, force_reg=1e-4,
                           grad_clip=clip)
    _assert_history(h, jh)
    assert h["obs_loss"][-1] < h["obs_loss"][0]
    assert f.shape == (n, B, N)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5)


def _fluid_batch(n, seed):
    rng = np.random.default_rng(seed)
    obs = rng.uniform(0, 1, size=(B, n + 1, H, H, 1)).astype(np.float32)
    return {"obs": obs,
            "vy0": (0.05 * rng.normal(size=(B, H + 1, H))).astype(np.float32),
            "vx0": (0.05 * rng.normal(size=(B, H, H + 1))).astype(np.float32),
            "inflow": (0.05 * rng.uniform(size=(B, H, H))).astype(np.float32)}


def _fluid_pdes():
    plate = default_obstacles(H, H)
    jpde = JFluid(JDomain.create(H, H, obstacle_mask=jnp.asarray(plate)),
                  JFConfig(**_FCFG), control="buoyancy", with_inflow=True)
    pde = IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=plate, device="cpu"),
        FluidConfig(**_FCFG), control="buoyancy", with_inflow=True)
    return jpde, pde


def test_optimize_forces_on_a_fluid_matches_jax():
    n, it = 2, 3
    batch = _fluid_batch(n, 1)
    jpde, pde = _fluid_pdes()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jf, jh = joptimize(jpde, jpde.initial_state(jb), jb["obs"][:, n], n=n,
                       iterations=it, learning_rate=0.5, force_reg=3e-4)
    tb = {k: _t(v) for k, v in batch.items()}
    f, h = optimize_forces(pde, pde.initial_state(tb), tb["obs"][:, n], n=n,
                           iterations=it, learning_rate=0.5, force_reg=3e-4)
    _assert_history(h, jh)
    assert isinstance(f, Staggered2D) and f.vy.shape == (n, B, H + 1, H)
    np.testing.assert_allclose(f.vy.numpy(), np.asarray(jf.vy), atol=1e-5)
    np.testing.assert_allclose(f.vx.numpy(), np.asarray(jf.vx), atol=1e-5)
    assert float(f.vy.abs().max()) > 0


def test_a_second_call_reuses_the_program_reset():
    n = 4
    a, b = _burgers_batch(n, 2), _burgers_batch(n, 3)
    kw = dict(n=n, iterations=4, learning_rate=0.1, force_reg=1e-4)
    pde = BurgersPDE(BurgersConfig(**_BCFG), device="cpu")
    optimize_forces(pde, _t(a[:, 0, :, 0]), _t(a[:, n]), **kw)
    f, h = optimize_forces(pde, _t(b[:, 0, :, 0]), _t(b[:, n]), **kw)
    assert len(pde._adjoint_programs) == 1
    fresh = BurgersPDE(BurgersConfig(**_BCFG), device="cpu")
    f2, h2 = optimize_forces(fresh, _t(b[:, 0, :, 0]), _t(b[:, n]), **kw)
    assert torch.equal(f, f2)
    for k in _KEYS:
        np.testing.assert_array_equal(h[k], h2[k])


def test_force_abs_mean_and_force_at_take_tensor_and_dataclass_forces():
    rng = np.random.default_rng(4)
    fb = rng.normal(size=(3, B, N)).astype(np.float32)
    vy = rng.normal(size=(3, B, H + 1, H)).astype(np.float32)
    vx = rng.normal(size=(3, B, H, H + 1)).astype(np.float32)
    jb = JBurgers(JBConfig(**_BCFG))
    jf, tf = _fluid_pdes()
    tb = BurgersPDE(BurgersConfig(**_BCFG), device="cpu")
    for t in range(3):
        got = tb.force_abs_mean(curriculum._force_at(_t(fb), t))
        np.testing.assert_allclose(got.numpy(),
                                   jb.force_abs_mean(jnp.asarray(fb[t])),
                                   atol=1e-6)
        stag = curriculum._force_at(Staggered2D(vy=_t(vy), vx=_t(vx)), t)
        assert isinstance(stag, Staggered2D)
        np.testing.assert_allclose(
            tf.force_abs_mean(stag).numpy(),
            jf.force_abs_mean(JStaggered(vy=jnp.asarray(vy[t]),
                                         vx=jnp.asarray(vx[t]))), atol=1e-6)


# ------------------------------------------------------------------- CLI

def _cli(name, wd):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        run.main([name, "--smoke-test", "--device", "cpu", "--workdir", wd])
    return json.loads(out.getvalue())


def test_cli_burgers_adjoint(tmp_path):
    wd = str(tmp_path / "adj")
    res = _cli("burgers_adjoint", wd)
    with open(os.path.join(wd, "results.json")) as f:
        assert json.load(f) == res
    for key in ("final_obs_mse", "initial_obs_mse", "mean_force_cost"):
        assert np.isfinite(res[key]), key
    assert res["final_obs_mse"] < res["initial_obs_mse"]


_ROWS = ("chain_final", "staggered", "refined", "adjoint", "zero_force")
_SCHEME_KEYS = ("final_state_mse", "final_state_mse_sem", "mean_force_cost",
                "mean_abs_force", "zero_force_final_mse", "eval_samples",
                "per_frame_mse")
_ADJOINT_KEYS = ("final_state_mse", "final_state_mse_sem", "mean_abs_force",
                 "mean_force_cost", "iterations", "microbatch",
                 "num_trajectories")


def _check_rows(res, n, adjoint_iterations, microbatch, trajectories):
    for row in _ROWS:
        assert row in res, row
    for scheme in compare_schemes.SCHEMES:
        for key in _SCHEME_KEYS:
            assert key in res[scheme], (scheme, key)
        assert len(res[scheme]["per_frame_mse"]) == n
    adj = res["adjoint"]
    assert set(_ADJOINT_KEYS) <= set(adj)
    assert (adj["iterations"], adj["microbatch"], adj["num_trajectories"]) == (
        adjoint_iterations, microbatch, trajectories)
    assert adj["mean_abs_force"] > 0
    assert np.isfinite(res["zero_force"]["final_state_mse"])


def test_cli_compare_burgers(tmp_path):
    wd = str(tmp_path / "cmp")
    res = _cli("compare_burgers", wd)
    with open(os.path.join(wd, "comparison.json")) as f:
        assert json.load(f) == res
    _check_rows(res, 4, 500, 16, 16)
    assert res["adjoint"]["final_state_mse"] < res["zero_force"][
        "final_state_mse"]


def test_run_comparison_on_a_smoke_setup(tmp_path, monkeypatch):
    from pde_control_tpu_torch.data.generate import (
        generate_inflow_smoke_dataset,
    )

    n = 4
    domain = Domain2D.create(H, H, obstacle_mask=default_obstacles(H, H),
                             device="cpu")
    cfg = FluidConfig(dt=1.0, buoyancy=0.08, pressure_tol=1e-4,
                      pressure_maxiter=200, warm_start_pressure=True)
    train = generate_inflow_smoke_dataset(domain, cfg, 4, n, seed=0)
    val = generate_inflow_smoke_dataset(domain, cfg, 4, n, seed=999)
    pde = IncompressibleFluidPDE(domain, cfg, control="buoyancy",
                                 with_inflow=True, unet_levels=2,
                                 cfe_features=(4, 4), op_base_features=2,
                                 dtype=torch.float32)
    kw = dict(batch_size=2, iterations=2, steps_per_call=1, force_reg=3e-4,
              adjoint_iterations=3, adjoint_lr=0.5, adjoint_microbatch=2)
    wd = str(tmp_path / "smoke")
    res = compare_schemes.run_comparison(pde, n, train, val, wd, **kw)
    _check_rows(res, n, 3, 2, 4)
    for tag in ("cfe", "chain_final", "staggered", "refined", "ops"):
        assert os.path.isdir(os.path.join(wd, f"ckpt_{tag}")), tag

    def no_training(*a, **k):
        raise AssertionError("a resumed comparison trained a stage")

    monkeypatch.setattr(ControlTraining, "train", no_training)
    monkeypatch.setattr(compare_schemes, "optimize_forces", no_training)
    again = compare_schemes.run_comparison(pde, n, train, val, wd,
                                           resume=True, **kw)
    assert again == json.loads(json.dumps(res))
