"""The plated 3D task of the port (`experiments/smoke3d.py`:
`obstacle_plate_3d`, the inflow, `generate_inflow_smoke3d_dataset`,
`smoke3d_indirect*`) and the CG's captured loop (`physics/poisson.py ::
cg`) against the JAX package's, on the CPU.

Held to:
* the plate exactly;
* the inflow built from the JAX package's draws within rtol 1e-6 of
  `random_inflow_3d`;
* `generate_inflow_smoke3d_dataset` (8³, 4 trajectories in chunks of 2,
  n=2, the task's pressure tol 1e-4 / maxiter 200, 6 warm-up steps) with
  its draws replaced by the JAX package's: obs, `inflow` and `vz0`,
  `vy0`, `vx0` within 1e-5 of their scale;
* both entries' setups and CurriculumConfigs as the JAX package's;
* `run smoke3d_indirect --smoke-test --device cpu` end to end, then
  `smoke3d_indirect_ft` from its ckpt_final;
* the CG's loop as a CUDA graph's capture runs it (all `maxiter` trips;
  here forced on the CPU, where nothing is captured) against the eager,
  host-checked loop, on the 3D plate and on a 2D plate, warm and cold,
  with a sample whose rhs holds a NaN: x_best and the trip counts bit for
  bit, through `solve_pressure` forward and backward too; and against the
  JAX package's `solve_pressure` within 1e-5 (p) and 1e-4 (gradient) of
  their scale, as `tests/test_torch_smoke3d.py` holds the eager loop.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu import grids as jgrids2d
from pde_control_tpu import grids3d as jgrids
from pde_control_tpu.experiments import smoke3d as jsmoke3d
from pde_control_tpu.physics import fluid3d as jfluid
from pde_control_tpu.physics.poisson import solve_pressure as jsolve
from pde_control_tpu_torch import grids, grids3d
from pde_control_tpu_torch.experiments import smoke3d
from pde_control_tpu_torch.physics import fluid3d, poisson

torch.set_num_threads(1)

D = 8
TASK_CFG = dict(dt=0.7, buoyancy=0.05, pressure_tol=1e-4,
                pressure_maxiter=200, warm_start_pressure=True)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, limit, label=""):
    """max|got - want| within `limit` of max|want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, label
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= limit * scale, f"{label}: {err:.3e} > {limit} x {scale:.3e}"


# ------------------------------------------------------------ the task


@pytest.mark.parametrize("shape", [(8, 8, 8), (32, 32, 32), (9, 7, 12)])
def test_obstacle_plate_matches_jax(shape):
    got = smoke3d.obstacle_plate_3d(*shape)
    np.testing.assert_array_equal(got, jsmoke3d.obstacle_plate_3d(*shape))
    assert got.dtype == np.float32 and 0 < got.sum() < got.size


def _inflow_draws(key, b, h, w):
    """`random_inflow_3d`'s draws from `key`, as (B, 2)."""
    pos = jax.random.uniform(
        key, (b, 2, 1, 1, 1),
        minval=jnp.array([0.2 * h, 0.2 * w], jnp.float32)[None, :, None, None,
                                                          None],
        maxval=jnp.array([0.8 * h, 0.8 * w], jnp.float32)[None, :, None, None,
                                                          None])
    return np.asarray(pos).reshape(b, 2)


def _smooth_draws(key, b, modes=2):
    """`random_smooth_field_3d`'s draws from `key`."""
    k_amp, k_pz, k_py, k_px = jax.random.split(key, 4)
    return (jax.random.normal(k_amp, (b, modes, modes, modes)),
            *(jax.random.uniform(k, (b, modes, 1), maxval=2 * jnp.pi)
              for k in (k_pz, k_py, k_px)))


@pytest.mark.parametrize("shape", [(8, 8, 8), (12, 10, 16)])
def test_inflow_from_jax_draws_matches_jax(shape):
    d, h, w = shape
    key = jax.random.PRNGKey(5)
    got = smoke3d.inflow3d_from_draws(_t(_inflow_draws(key, 3, h, w)), d, h, w)
    want = jsmoke3d.random_inflow_3d(key, 3, d, h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-30)
    gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    pos = smoke3d.inflow3d_draws(gen(), 256, h, w)
    assert float(pos[:, 0].min()) >= 0.2 * h and float(pos[:, 0].max()) < 0.8 * h
    assert float(pos[:, 1].min()) >= 0.2 * w and float(pos[:, 1].max()) < 0.8 * w
    assert torch.equal(smoke3d.random_inflow_3d(gen(), 2, d, h, w),
                       smoke3d.random_inflow_3d(gen(), 2, d, h, w))


def test_dataset_from_jax_draws_matches_jax(monkeypatch):
    """`generate_inflow_smoke3d_dataset` on the plate, its draws replaced
    by the JAX package's for its seed."""
    num, n, seed, batch = 4, 2, 7, 2
    key, draws = jax.random.PRNGKey(seed), []
    for _ in range(num // batch):
        key, k1, k2 = jax.random.split(key, 3)
        draws.append((_inflow_draws(k1, batch, D, D), _smooth_draws(k2, batch)))
    it = iter(draws)
    fields = []

    def inflow_draws(gen, b, h, w):
        pos, field = next(it)
        fields.append(field)
        return _t(pos)

    monkeypatch.setattr(smoke3d, "inflow3d_draws", inflow_draws)
    monkeypatch.setattr(smoke3d, "smooth3d_draws",
                        lambda gen, b: tuple(map(_t, fields[-1])))
    plate = smoke3d.obstacle_plate_3d(D, D, D)
    td = grids3d.Domain3D.create(D, D, D, obstacle_mask=plate, device="cpu")
    jd = jgrids.Domain3D.create(D, D, D, obstacle_mask=jnp.asarray(plate))
    got = smoke3d.generate_inflow_smoke3d_dataset(
        td, fluid3d.Fluid3DConfig(**TASK_CFG), num, n, seed=seed, batch=batch)
    want = jsmoke3d.generate_inflow_smoke3d_dataset(
        jd, jfluid.Fluid3DConfig(**TASK_CFG), num, n, seed=seed, batch=batch)
    assert got.obs.shape == want.obs.shape == (num, n + 1, D, D, D, 1)
    assert set(got.extras) == set(want.extras) == {"inflow", "vz0", "vy0",
                                                   "vx0"}
    _close(got.obs, want.obs, 1e-5, "obs")
    for k in want.extras:
        assert got.extras[k].shape == want.extras[k].shape, k
        _close(got.extras[k], want.extras[k], 1e-5, k)
    assert np.abs(got.obs[:, n] - got.obs[:, 0]).max() > 1e-4
    assert np.abs(got.extras["vz0"]).max() > 1e-4  # the warm-up moved it


def _entry_calls(module, entry, monkeypatch, **kw):
    """The setup's datasets' arguments, the PDE and the CurriculumConfig
    `entry` hands to run_curriculum / finetune_e2e, with the datasets
    stubbed out."""
    got = []
    monkeypatch.setattr(module, "generate_inflow_smoke3d_dataset",
                        lambda domain, cfg, *a, **k:
                        got.append(("data", domain, cfg, a, k)))
    for runner in ("run_curriculum", "finetune_e2e"):
        monkeypatch.setattr(module, runner, lambda pde, cfg, *a, **k:
                            got.append(("run", pde, cfg)) or {})
    extra = {"device": "cpu"} if module is smoke3d else {}
    getattr(module, entry)("unused", size=8, n=2, **kw, **extra)
    data = [(dataclasses.asdict(c), a, k) for _, _, c, a, k in got[:2]]
    _, pde, ccfg = got[2]
    assert got[0][1] is got[1][1] is pde.domain
    return data, (pde.control, pde.unet_levels, pde.with_inflow,
                  pde.domain.has_obstacles, pde.domain.closed,
                  np.asarray(pde.domain.fluid_mask).tolist()), \
        dataclasses.asdict(ccfg)


@pytest.mark.parametrize("entry, kw", [
    ("run_smoke3d_indirect", {}),
    ("run_smoke3d_indirect", dict(iterations=3, batch_size=4, seed=2)),
    ("run_smoke3d_indirect_ft", dict(init_from="ckpt")),
    ("run_smoke3d_indirect_ft", dict(init_from="ckpt", force_reg=1e-5,
                                     e2e_iterations=7)),
])
def test_entries_match_jax(entry, kw, monkeypatch):
    got = _entry_calls(smoke3d, entry, monkeypatch, **kw)
    want = _entry_calls(jsmoke3d, entry, monkeypatch, **kw)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == {k: want[2][k] for k in got[2]}


def test_cli_smoke3d_indirect_on_the_cpu(tmp_path):
    """`run smoke3d_indirect --smoke-test` end to end on the CPU (8³ with
    the plate, n=2), then `smoke3d_indirect_ft` from its ckpt_final."""
    from pde_control_tpu_torch.experiments import run

    wd = str(tmp_path / "s3i")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        run.main(["smoke3d_indirect", "--smoke-test", "--device", "cpu",
                  "--iterations", "2", "--workdir", wd])
    with open(os.path.join(wd, "results.json")) as f:
        res = json.load(f)
    assert json.loads(out.getvalue())["eval"] == res["eval"]
    for key in ("cfe_supervised", "op2_supervised", "end_to_end_n2", "eval"):
        assert key in res, key
    assert np.isfinite(res["eval"]["final_state_mse"])
    assert np.isfinite(res["eval"]["zero_force_final_mse"])
    ft = str(tmp_path / "ft")
    with contextlib.redirect_stdout(io.StringIO()):
        run.main(["smoke3d_indirect_ft", "--smoke-test", "--device", "cpu",
                  "--e2e-iterations", "1", "--workdir", ft, "--init-from",
                  os.path.join(wd, "ckpt_final")])
    with open(os.path.join(ft, "results.json")) as f:
        assert np.isfinite(json.load(f)["eval"]["final_state_mse"])


# ------------------------------------------------- the CG's captured loop


def _plate_2d(h: int) -> np.ndarray:
    m = np.zeros((h, h), np.float32)
    m[h // 2, :] = 1.0
    m[h // 2, 3:7] = 0.0
    return m


@functools.cache
def _systems(dim: int):
    """(JAX domain, port domain, div (3, …), x0, cotangent) on the 3D
    plate at 8³ or a 2D plate at 16²; div[2] holds a NaN."""
    rng = np.random.default_rng(20 + dim)
    if dim == 3:
        shape, mask = (D, D, D), smoke3d.obstacle_plate_3d(D, D, D)
        jd = jgrids.Domain3D.create(*shape, obstacle_mask=jnp.asarray(mask))
        td = grids3d.Domain3D.create(*shape, obstacle_mask=mask, device="cpu")
    else:
        shape, mask = (16, 16), _plate_2d(16)
        jd = jgrids2d.Domain2D.create(*shape, obstacle_mask=jnp.asarray(mask))
        td = grids.Domain2D.create(*shape, obstacle_mask=mask, device="cpu")
    div = rng.normal(size=(3,) + shape).astype(np.float32)
    div[2].flat[5] = np.nan
    x0 = rng.normal(size=div.shape).astype(np.float32)
    cot = rng.normal(size=div.shape).astype(np.float32)
    return jd, td, div, x0, cot


@functools.cache
def _jax_solve(dim: int, warm: bool):
    """The JAX package's p and gradient of sum(cot·p) on the finite
    samples, tol 1e-6 / maxiter 500."""
    jd, _, div, x0, cot = _systems(dim)
    kw = dict(tol=1e-6, maxiter=500,
              x0=jnp.asarray(x0[:2]) if warm else None)
    p, vjp = jax.vjp(lambda d: jsolve(d, jd, **kw), jnp.asarray(div[:2]))
    return np.asarray(p), np.asarray(vjp(jnp.asarray(cot[:2]))[0])


def _solve(dim: int, warm: bool, captured: bool, monkeypatch, maxiter=500):
    """The port's solve_pressure on all three samples, forward and
    backward, with the loop of a capture or the eager one."""
    monkeypatch.setattr(poisson, "_capturing", lambda t: captured)
    _, td, div, x0, cot = _systems(dim)
    d = _t(div).requires_grad_(True)
    p = poisson.solve_pressure(d, td, tol=1e-6, maxiter=maxiter,
                               backend="pcg", x0=_t(x0) if warm else None)
    (p * _t(cot)).sum().backward()
    return p.detach().numpy(), d.grad.numpy()


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("dim", [3, 2])
def test_captured_loop_matches_eager_and_jax(dim, warm, monkeypatch):
    """All maxiter trips give the host-checked loop's x_best and trip
    counts bit for bit (the trips after every sample froze are no-ops),
    forward and backward, and the JAX package's solve on the finite
    samples."""
    _, td, div, x0, _ = _systems(dim)
    project = poisson._projector(td)

    def matvec(p):
        return project(poisson.masked_laplace_spd(project(p), td))

    def precond(r):
        return project(poisson.spectral_neumann_solve(project(r), dx=td.dx))

    rhs = project(torch.where(td.fluid_mask > 0, -_t(div), 0.0))
    guess = project(_t(x0)) if warm else None
    runs = {}
    for captured in (False, True):
        monkeypatch.setattr(poisson, "_capturing", lambda t: captured)
        runs[captured] = poisson.cg(matvec, rhs, tol=1e-6, maxiter=200,
                                    x0=guess, precond=precond,
                                    return_iters=True)
    (x_e, k_e), (x_c, k_c) = runs[False], runs[True]
    np.testing.assert_array_equal(x_c.numpy(), x_e.numpy())
    assert torch.equal(k_c, k_e) and k_e.dtype == torch.int32
    assert int(k_e[2]) == 0 and 0 < int(k_e.max()) < 200
    assert torch.isnan(x_e[2]).sum() == 0  # the NaN sample keeps its start

    p_e, g_e = _solve(dim, warm, False, monkeypatch)
    p_c, g_c = _solve(dim, warm, True, monkeypatch)
    np.testing.assert_array_equal(p_c, p_e)
    np.testing.assert_array_equal(g_c, g_e)
    jp, jg = _jax_solve(dim, warm)
    _close(p_c[:2], jp, 1e-5, "p")
    _close(g_c[:2], jg, 1e-4, "grad")
