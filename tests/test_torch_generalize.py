"""The out-of-distribution evals (`experiments/generalize.py`) against the
JAX package, on the CPU at 16², n=4, batch 4.

* `_row` of both packages on the same dataset (the JAX package's) and the
  same checkpoint, written by the JAX package and restored by each:
  `final_state_mse`, `zero_force_final_mse` and the ratio at rtol 1e-5, as
  `tests/test_torch_curriculum.py` holds the eval blocks.
  - 'shapes': config 3's task as `generalize_shapes` builds it (bf16 nets,
    the random-init checkpoint, whose CFE applies no force), staggered and
    chain_final;
  - 'smoke': config 4's task with fp32 nets, pressure tol 1e-6 and the
    CFE's output layer perturbed, so that the controlled rollout differs
    from the zero-force one.
  (In `tests/test_torch_generalize_rows.py`, a file of at most five
  tests, which the test run hands out last.)
* `ood_obstacles(64, 64)` equals the JAX package's exactly.
* `_render_worst` on 10 samples in chunks of 4 gives the worst indices of
  a plain argsort over every sample, and writes their PNGs.
* Both entries through the CLI (`--smoke-test --device cpu`) from a
  random-init JAX checkpoint: `results.json` with the JAX module's row
  keys, the `worst_*` PNGs, and a 'shapes' ratio within 1e-3 of 1.
"""

import contextlib
import functools
import io
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu.control.pde_fluid import IncompressibleFluidPDE as JPDE
from pde_control_tpu.control.training import ControlTraining as JApp
from pde_control_tpu.data import generate as jgenerate
from pde_control_tpu.experiments import generalize as jgen
from pde_control_tpu.experiments.fluid2d import default_obstacles
from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.physics.fluid import FluidConfig as JConfig
from pde_control_tpu_torch import Domain2D, FluidConfig, IncompressibleFluidPDE
from pde_control_tpu_torch.data.scene import TrajectoryDataset
from pde_control_tpu_torch.experiments import generalize, run

torch.set_num_threads(1)

H, N = 16, 4
NETS = ("CFE", "OP4", "OP2")


@functools.lru_cache(maxsize=None)
def _tmpdir():
    return tempfile.mkdtemp(prefix="test_torch_generalize_")


def _cfg(task, tol):
    return dict(dt=1.0, buoyancy=0.0 if task == "shapes" else 0.08,
                pressure_tol=tol, pressure_maxiter=200 if tol == 1e-4 else 500,
                warm_start_pressure=True)


def _pde_kw(task, width_cfe=(48, 96, 96, 48)):
    if task == "shapes":
        return dict(control="direct", unet_levels=2)
    return dict(control="buoyancy", with_inflow=True, unet_levels=2,
                cfe_features=width_cfe, op_base_features=16)


def _pdes(task, tol, fp32):
    mask = default_obstacles(H, H) if task == "smoke" else None
    jd = JDomain.create(H, H, obstacle_mask=None if mask is None
                        else jnp.asarray(mask))
    td = Domain2D.create(H, H, obstacle_mask=None if mask is None
                         else np.array(mask), device="cpu")
    jkw = dict(_pde_kw(task), **({"dtype": jnp.float32} if fp32 else {}))
    tkw = dict(_pde_kw(task), **({"dtype": torch.float32} if fp32 else {}))
    return (JPDE(jd, JConfig(**_cfg(task, tol)), **jkw),
            IncompressibleFluidPDE(td, FluidConfig(**_cfg(task, tol)), **tkw))


@functools.lru_cache(maxsize=None)
def _checkpoint(task, perturbed=False):
    """A random-init JAX checkpoint of `task`'s nets (its CFE's output layer
    drawn from a numpy seed when `perturbed`)."""
    jpde, _ = _pdes(task, 1e-4, fp32=perturbed)
    app = JApp(N, jpde, batch_size=4, trainable_networks=NETS,
               sequence_class="staggered", obs_loss_frames=(N,),
               seed=0).prepare()
    if perturbed:
        params = jax.tree_util.tree_map(np.array, jax.device_get(app.params))
        k = params["CFE"]["Conv_4"]["kernel"]
        params["CFE"]["Conv_4"]["kernel"] = (
            0.05 * np.random.default_rng(5).normal(size=k.shape)
        ).astype(np.float32)
        app.params = jax.tree_util.tree_map(jnp.asarray, params)
    path = os.path.join(_tmpdir(), f"ckpt_{task}_{int(perturbed)}")
    app.save(path)
    return path


@functools.lru_cache(maxsize=None)
def _jax_data(task, tol):
    jpde, _ = _pdes(task, tol, fp32=False)
    if task == "shapes":
        ds = jgenerate.generate_forced_smoke_dataset(
            jpde.domain, jpde.cfg, 8, N, seed=999, init="shapes")
    else:
        ds = jgenerate.generate_inflow_smoke_dataset(
            jpde.domain, jpde.cfg, 8, N, seed=999, control_amplitude=1.0)
    return ds


ROW_CASES = {"shapes-staggered": ("shapes", "staggered", 1e-4, False),
             "shapes-chain_final": ("shapes", "chain_final", 1e-4, False),
             "smoke-perturbed": ("smoke", "staggered", 1e-6, True)}


@functools.lru_cache(maxsize=None)
def _rows(case):
    task, scheme, tol, perturbed = ROW_CASES[case]
    ckpt = _checkpoint(task, perturbed)
    restore = ({name: ckpt for name in NETS} if scheme == "staggered"
               else {"CFE": ckpt})
    jpde, tpde = _pdes(task, tol, fp32=perturbed)
    jval = _jax_data(task, tol)
    tval = TrajectoryDataset(jval.obs, **jval.extras)
    japp = jgen._eval_app(jpde, N, jval, restore, scheme, batch_size=4)
    tapp = generalize._eval_app(tpde, N, tval, restore, scheme, batch_size=4)
    return jgen._row(japp, jval, N), generalize._row(tapp, tval, N)


def test_ood_obstacles_match_jax():
    got, want = generalize.ood_obstacles(64, 64), jgen.ood_obstacles(64, 64)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got != np.asarray(default_obstacles(64, 64))).any()


def test_render_worst_scans_every_sample(tmp_path):
    _, tpde = _pdes("smoke", 1e-4, fp32=True)
    rng = np.random.default_rng(3)
    val = TrajectoryDataset(
        rng.uniform(0, 1, size=(10, N + 1, H, H, 1)).astype(np.float32),
        inflow=rng.uniform(0, 0.05, size=(10, H, H)).astype(np.float32))
    app = generalize._eval_app(tpde, N, val, {n: _checkpoint("smoke", True)
                                              for n in NETS},
                               "staggered", batch_size=4)
    worst = generalize._render_worst(app, val, N, str(tmp_path), "t", k=4,
                                     chunk=4)
    obs, _, _ = app.infer_all_frames(val.take(np.arange(10)))
    mses = np.mean((obs.numpy()[N - 1] - val.obs[:, N]) ** 2, axis=(1, 2, 3))
    assert worst == [int(i) for i in np.argsort(mses)[::-1][:4]]
    assert sorted(os.listdir(tmp_path)) == [f"worst_t_{r}.png" for r in range(4)]


SHAPES_KEYS = {"init_from", "protocol", "shapes", "shapes_chain", "crosses",
               "crosses_chain", "rings", "rings_chain", "shapes_worst_idx",
               "rings_worst_idx"}
SMOKE_KEYS = {"init_from", "in_dist", "in_dist_chain", "obstacles_ood",
              "inflow_shifted"}


@pytest.mark.parametrize("name", ["generalize_shapes", "generalize_smoke"])
def test_cli_entry_on_the_cpu(name, tmp_path):
    task = "shapes" if name == "generalize_shapes" else "smoke"
    wd = str(tmp_path / "out")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        run.main([name, "--smoke-test", "--device", "cpu", "--workdir", wd,
                  "--init-from", _checkpoint(task)])
    with open(os.path.join(wd, "results.json")) as f:
        res = json.load(f)
    first = json.loads(out.getvalue().splitlines()[0])  # the first row
    assert list(first) == ["shapes" if task == "shapes" else "in_dist"]
    row_keys = set(_rows("shapes-staggered")[0])
    if task == "shapes":
        assert set(res) == SHAPES_KEYS
        rows = [k for k in SHAPES_KEYS if k in ("shapes", "crosses", "rings")
                or k.endswith("_chain")]
        assert abs(res["shapes"]["ratio_vs_zero_force"] - 1.0) < 1e-3
        assert sorted(f for f in os.listdir(wd) if f.startswith("worst_")) == \
            [f"worst_{t}_{r}.png" for t in ("rings", "shapes") for r in range(4)]
    else:
        assert set(res) == SMOKE_KEYS
        rows = sorted(SMOKE_KEYS - {"init_from"})
        assert res["in_dist_chain"]["scheme"] == "chain_final"
    for key in rows:
        assert set(res[key]) - {"scheme"} == row_keys, key
        assert np.isfinite(res[key]["final_state_mse"]), key
        assert np.isfinite(res[key]["zero_force_final_mse"]), key


@pytest.mark.parametrize("argv, message", [
    (["generalize_smoke"], "requires --init-from"),
    (["generalize_shapes", "--width", "2", "--init-from", "x"],
     "--width is not supported"),
    (["smoke3d_indirect_ft", "--mesh", "2"], "needs a torchrun launch"),
    (["generalize_shapes", "--init-from", "x", "--mesh", "4"], "--mesh"),
    (["smoke3d_indirect", "--mesh", "2"], "needs a torchrun launch"),
])
def test_cli_refuses(argv, message, capsys):
    with pytest.raises(SystemExit):
        run.main(argv + ["--device", "cpu"])
    assert message in capsys.readouterr().err
