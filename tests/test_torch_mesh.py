"""Data parallelism (`parallel/mesh.py`, `ControlTraining(mesh=)`) on a
world of two gloo ranks on the CPU, against the JAX package's
`ControlTraining(mesh=make_mesh(2))` on the same weights and batches and
against the port's `mesh=None`.

The ranks run in spawned processes (`tests/_torch_dist.py`: one thread
each, a FileStore under tmp_path) while this process takes the JAX
references. Held to the JAX package's own DP check
(`tests/_mesh_equality_check.py`): the loss at rtol 1e-5 and every
parameter at rtol 1e-4, atol 1e-6, for
* Burgers (N=16, n=2, batch 8, 'chain', the CFE's output layer
  perturbed so that every layer has a gradient): one `progress`;
* the 2D fluid 'staggered' class at 16², n=2, batch 4 (CFE and OP2
  trainable, U-nets of 2 levels): one `progress`, then `progress_multi`
  of two steps (the JAX side runs the three steps as one
  `progress_multi`).
Also: the ranks hold bit-equal replicas (a rank that loads other weights
takes rank 0's), `evaluate` gives the global batch's numbers, a NaN in
one rank's shard skips the update on both ranks, a short `train` under
the mesh draws the `mesh=None` run's batches and only rank 0 writes,
and the errors: `make_mesh` on a wrong world size, a batch the mesh
does not divide, `run.py --mesh` without torchrun.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_dist as td
from pde_control_tpu.control.pde_burgers import BurgersPDE as JBurgers
from pde_control_tpu.control.pde_fluid import IncompressibleFluidPDE as JFluid
from pde_control_tpu.control.training import ControlTraining as JApp
from pde_control_tpu.data.generate import generate_burgers_dataset
from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.parallel.mesh import make_mesh as jmake_mesh
from pde_control_tpu.parallel.mesh import replicate as jreplicate
from pde_control_tpu.physics.burgers import BurgersConfig as JBurgersConfig
from pde_control_tpu.physics.fluid import FluidConfig as JFluidConfig
from pde_control_tpu_torch import params_from_flax
from pde_control_tpu_torch.control.training import ControlTraining
from pde_control_tpu_torch.data.scene import TrajectoryDataset
from pde_control_tpu_torch.experiments import run
from pde_control_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

H = 16
_FLUID_CFG = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-6,
                  pressure_maxiter=500)
_FLUID_PDE = dict(control="buoyancy", unet_levels=2,
                  cfe_features=(32, 64, 64, 32), op_base_features=16)
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 1e-4, 1e-6


def _perturb_last_conv(params, net="CFE"):
    """A nonzero output layer (0.05·N(0, 1) from a numpy seed), so that a
    gradient reaches every layer."""
    params = jax.tree_util.tree_map(np.array, jax.device_get(params))
    last = max((k for k in params[net] if k.startswith("Conv_")),
               key=lambda k: int(k.split("_")[1]))
    k = params[net][last]["kernel"]
    params[net][last]["kernel"] = (0.05 * np.random.default_rng(3).normal(
        size=k.shape)).astype(np.float32)
    return params


def _fluid_batch(seed):
    r = np.random.default_rng(seed)
    return {"obs": r.uniform(0, 1, size=(4, 3, H, H, 1)).astype(np.float32),
            "vy0": np.zeros((4, H + 1, H), np.float32),
            "vx0": np.zeros((4, H, H + 1), np.float32)}


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _torch_params(app):
    return td._params(app)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    jmesh = jmake_mesh(2)
    # Burgers: the JAX package's DP check's task and batch.
    bcfg = JBurgersConfig(n=16, dt=0.5, viscosity=0.05)
    data = generate_burgers_dataset(bcfg, num=32, n_steps=2, seed=0)
    batch = data.sample(np.random.default_rng(1), 8)
    nan_batch = {"obs": batch["obs"].copy()}
    nan_batch["obs"][5, 1, 3, 0] = np.nan  # in rank 1's shard (4..7)
    japp = JApp(2, JBurgers(bcfg), dataset=data, batch_size=8,
                trainable_networks=("CFE",), sequence_class="chain",
                obs_loss_frames=(1, 2), seed=3, mesh=jmesh).prepare()
    bparams = _perturb_last_conv(japp.params)
    japp.params = jreplicate(bparams, jmesh)
    tb = params_from_flax(bparams)
    obs = np.asarray(data.obs)
    # The fluid: staggered, CFE and OP2 trainable.
    jpde = JFluid(JDomain.create(H, H), JFluidConfig(**_FLUID_CFG),
                  dtype=jnp.float32, **_FLUID_PDE)
    jfl = JApp(2, jpde, batch_size=4, trainable_networks=("CFE", "OP2"),
               sequence_class="staggered", mesh=jmesh).prepare()
    fparams = _perturb_last_conv(jfl.params)
    jfl.params = jreplicate(fparams, jmesh)
    tf = params_from_flax(fparams)
    fb = [_fluid_batch(s) for s in range(3)]

    burgers = td.start_ranks(td.dp_burgers, 2, tmp / "burgers", tb, batch,
                             nan_batch, obs, str(tmp / "work"))
    fluid = td.start_ranks(td.dp_fluid, 2, tmp / "fluid", tf, _FLUID_PDE,
                           _FLUID_CFG, H, fb[0], _stack(fb[1:]))

    out = {"batch": batch}
    m = japp.progress(batch)
    out["jax_burgers"] = dict(loss=float(m["loss"]),
                              params=params_from_flax(jax.device_get(
                                  japp.params)))
    m = jfl.progress_multi(_stack(fb))
    out["jax_fluid"] = dict(loss=np.asarray(m["loss"]),
                            params=params_from_flax(jax.device_get(
                                jfl.params)))

    single = td._burgers_app(None, tb)
    out["single_burgers"] = dict(loss=float(single.progress(batch)["loss"]),
                                 params=_torch_params(single),
                                 eval=single.evaluate(batch))
    single = td._burgers_app(None, tb, dataset=TrajectoryDataset(obs))
    single.train(4, log_every=2, steps_per_call=2, render=False)
    out["single_trained"] = _torch_params(single)
    single = td._fluid_app(None, tf, _FLUID_PDE, _FLUID_CFG, H)
    loss = float(single.progress(fb[0])["loss"])
    p1 = _torch_params(single)
    m = single.progress_multi(_stack(fb[1:]))
    out["single_fluid"] = dict(loss=loss, params=p1,
                               multi_loss=m["loss"].numpy(),
                               multi_params=_torch_params(single))
    out["burgers"] = td.join_ranks(burgers)
    out["fluid"] = td.join_ranks(fluid)
    out["work"] = tmp / "work"
    return out


def _close(got: dict, want: dict, rtol=P_RTOL, atol=P_ATOL):
    for net, sd in want.items():
        for k, v in sd.items():
            np.testing.assert_allclose(got[net][k], np.asarray(v), rtol=rtol,
                                       atol=atol, err_msg=f"{net}.{k}")


@pytest.mark.parametrize("rank", [0, 1])
def test_burgers_loss_matches_jax_mesh_and_single(runs, rank):
    r = runs["burgers"][rank]
    np.testing.assert_allclose(r["loss"], runs["jax_burgers"]["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(r["loss"], runs["single_burgers"]["loss"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("ref", ["jax_burgers", "single_burgers"])
def test_burgers_params_after_progress(runs, rank, ref):
    _close(runs["burgers"][rank]["params"], runs[ref]["params"])


@pytest.mark.parametrize("rank", [0, 1])
def test_fluid_progress_matches(runs, rank):
    r = runs["fluid"][rank]
    np.testing.assert_allclose(r["loss"], runs["jax_fluid"]["loss"][0],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(r["loss"], runs["single_fluid"]["loss"],
                               rtol=LOSS_RTOL)
    _close(r["params"], runs["single_fluid"]["params"])


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("ref", ["jax_fluid", "single_fluid"])
def test_fluid_progress_multi_matches(runs, rank, ref):
    r = runs["fluid"][rank]
    want = runs[ref]
    want_loss = want["loss"][1:] if ref == "jax_fluid" else want["multi_loss"]
    np.testing.assert_allclose(r["multi_loss"], want_loss, rtol=LOSS_RTOL)
    _close(r["multi_params"], want["params"] if ref == "jax_fluid"
           else want["multi_params"])


@pytest.mark.parametrize("key", ["start", "params", "trained"])
def test_ranks_hold_equal_replicas(runs, key):
    """Rank 1 loaded other weights: the broadcast gives it rank 0's, and
    the all-reduced steps keep the replicas bit for bit equal."""
    a, b = runs["burgers"][0][key], runs["burgers"][1][key]
    for net, sd in a.items():
        for k, v in sd.items():
            assert np.array_equal(v, b[net][k]), f"{key} {net}.{k}"


def test_fluid_ranks_equal(runs):
    a, b = runs["fluid"]
    for key in ("params", "multi_params"):
        for net, sd in a[key].items():
            for k, v in sd.items():
                assert np.array_equal(v, b[key][net][k])


@pytest.mark.parametrize("rank", [0, 1])
def test_evaluate_gives_the_global_batch(runs, rank):
    got, want = runs["burgers"][rank]["eval"], runs["single_burgers"]["eval"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL)


@pytest.mark.parametrize("rank", [0, 1])
def test_nan_in_one_shard_skips_on_every_rank(runs, rank):
    nan = runs["burgers"][rank]["nan"]
    assert not np.isfinite(nan["loss"])
    assert (nan["total"], nan["consec"], nan["count"]) == (1, 1, 1)
    assert nan["kept"]


def test_train_under_the_mesh_draws_the_single_run_batches(runs):
    _close(runs["burgers"][0]["trained"], runs["single_trained"])


def test_only_rank0_writes(runs):
    work = runs["work"]
    assert os.path.exists(work / "logs_r0" / "metrics.jsonl")
    assert not os.path.exists(work / "logs_r1")
    assert os.path.exists(work / "autosave" / "state.json")
    assert os.path.exists(work / "ckpt" / "CFE.msgpack")


def test_make_mesh_refuses_a_wrong_world_size(runs):
    for r in runs["burgers"]:
        assert r["size"] == 2
        assert "requested 3 devices" in r["wrong_world"]


def test_batch_size_must_divide_over_the_mesh():
    mesh = Mesh(("data",), {"data": 3}, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        ControlTraining(2, None, batch_size=8, mesh=mesh,
                        device="cpu")


@pytest.mark.parametrize("name", ["smoke_indirect", "burgers_chain"])
def test_cli_mesh_needs_torchrun(name, monkeypatch, capsys):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit):
        run.main([name, "--mesh", "2", "--smoke-test", "--device", "cpu"])
    err = capsys.readouterr().err
    assert ("torchrun" in err) if name == "smoke_indirect" else (
        "not supported" in err)
