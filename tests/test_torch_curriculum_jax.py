"""`ControlTraining.train` and `curriculum.finetune_e2e` against the JAX
package's (`tests/test_torch_curriculum.py`'s inputs and tolerances). In
a file of their own, of at most five tests, because they take most of
that file's time.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu.control.pde_fluid import IncompressibleFluidPDE as JPDE
from pde_control_tpu.control.training import ControlTraining as JApp
from pde_control_tpu.data.scene import TrajectoryDataset as JDataset
from pde_control_tpu.experiments import curriculum as jcurriculum
from pde_control_tpu.experiments.fluid2d import default_obstacles
from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.physics.fluid import FluidConfig as JConfig
from pde_control_tpu_torch import ControlTraining, params_from_flax
from pde_control_tpu_torch.data.scene import TrajectoryDataset
from pde_control_tpu_torch.experiments import curriculum
from pde_control_tpu_torch.experiments.curriculum import CurriculumConfig
from pde_control_tpu_torch.utils.checkpoint import load_network

from test_torch_curriculum import (
    B,
    H,
    N,
    NETS,
    _APP,
    _CFG,
    _PDE,
    _datasets,
    _tpde,
)


def _jpde():
    return JPDE(JDomain.create(H, H, obstacle_mask=jnp.asarray(
        default_obstacles(H, H))), JConfig(**_CFG), dtype=jnp.float32, **_PDE)


def _perturbed(params):
    params = jax.tree_util.tree_map(np.array, params)
    k = params["CFE"]["Conv_2"]["kernel"]
    params["CFE"]["Conv_2"]["kernel"] = (
        0.05 * np.random.default_rng(5).normal(size=k.shape)).astype(np.float32)
    return params


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in ("time",
                                                     "train/steps_per_sec")}
            for r in recs]


def _assert_close_params(got: dict, want: dict, atol: float):
    for net, sd in want.items():
        for k, v in sd.items():
            np.testing.assert_allclose(got[net][k].numpy(), v.numpy(), rtol=0,
                                       atol=atol, err_msg=f"{net}.{k}")

_TRAIN = {}


def _train_case(k: int, iterations: int, tmp):
    if k not in _TRAIN:
        japp = JApp(N, _jpde(), dataset=_datasets(JDataset), logdir=str(
            tmp / f"j{k}"), **_APP).prepare()
        params = _perturbed(jax.device_get(japp.params))
        japp.params = jax.tree_util.tree_map(jnp.asarray, params)
        jres = japp.train(iterations, log_every=2, steps_per_call=k,
                          render=False)
        tapp = ControlTraining(N, _tpde(), dataset=_datasets(TrajectoryDataset),
                               logdir=str(tmp / f"t{k}"), **_APP).prepare()
        tapp.load_params(params_from_flax(params))
        tres = tapp.train(iterations, log_every=2, steps_per_call=k,
                          render=False)
        japp.logger.close()
        tapp.close()
        _TRAIN[k] = (jres, tres, _records(str(tmp / f"j{k}")),
                     _records(str(tmp / f"t{k}")),
                     params_from_flax(jax.device_get(japp.params)),
                     tapp.state_dicts(), japp.step_count, tapp.step_count,
                     params_from_flax(params))
    return _TRAIN[k]


@pytest.mark.parametrize("k, iterations", [(2, 4), (1, 3)])


def test_train_matches_jax(tmp_path, k, iterations):
    (jres, tres, jrecs, trecs, jparams, tparams, jsteps, tsteps,
     start) = _train_case(k, iterations, tmp_path)
    assert jsteps == tsteps == iterations
    assert set(jres) == set(tres)
    for key in jres:
        if key != "steps_per_sec":
            np.testing.assert_allclose(tres[key], jres[key], rtol=1e-5,
                                       err_msg=key)
    assert len(jrecs) == len(trecs) == 2
    for j, t in zip(jrecs, trecs):
        assert set(j) == set(t)
        for key in j:
            np.testing.assert_allclose(t[key], j[key], rtol=1e-5, err_msg=key)
    _assert_close_params(tparams, jparams, atol=1e-6)
    for net in NETS:  # every net trained
        assert any(not torch.equal(tparams[net][key], v)
                   for key, v in start[net].items()), net


def test_finetune_e2e_matches_jax(tmp_path):
    japp = JApp(N, _jpde(), **_APP).prepare()
    japp.params = jax.tree_util.tree_map(
        jnp.asarray, _perturbed(jax.device_get(japp.params)))
    init = str(tmp_path / "init")
    japp.save(init)
    cfg = dict(n=N, batch_size=B, e2e_iterations=2, steps_per_call=2,
               e2e_lr=1e-3, force_reg=1e-3, seed=1)
    jres = jcurriculum.finetune_e2e(
        _jpde(), jcurriculum.CurriculumConfig(**cfg), _datasets(JDataset),
        _datasets(JDataset, seed=1), str(tmp_path / "j"), init)
    tres = curriculum.finetune_e2e(
        _tpde(), CurriculumConfig(**cfg), _datasets(TrajectoryDataset),
        _datasets(TrajectoryDataset, seed=1), str(tmp_path / "t"), init)
    assert tres["finetune"]["iterations_run"] == 2
    je, te = jres["eval"], tres["eval"]
    assert set(je) == set(te)
    for key in ("final_state_mse", "zero_force_final_mse", "mean_abs_force",
                "mean_force_cost", "final_state_mse_std"):
        np.testing.assert_allclose(te[key], je[key], rtol=1e-5, err_msg=key)
    for key in ("per_frame_mse", "per_frame_zero_force_mse"):
        np.testing.assert_allclose(te[key], je[key], rtol=1e-5, atol=1e-9,
                                   err_msg=key)
    assert te["eval_samples"] == je["eval_samples"] == 6
    assert te["mean_abs_force"] > 0
    got = {n: load_network(str(tmp_path / "t" / "ckpt_final" / f"{n}.msgpack"))
           for n in NETS}
    want = {n: load_network(str(tmp_path / "j" / "ckpt_final" / f"{n}.msgpack"))
            for n in NETS}
    _assert_close_params(got, want, atol=1e-6)
    with open(tmp_path / "t" / "results.json") as f:
        assert "eval" in json.load(f)
    assert os.path.exists(tmp_path / "t" / "eval_sample0.png")
    again = curriculum.finetune_e2e(
        _tpde(), CurriculumConfig(**cfg), _datasets(TrajectoryDataset),
        _datasets(TrajectoryDataset, seed=1), str(tmp_path / "t"), init,
        resume=True)
    assert again["finetune"] == {"resumed": True}
    assert again["eval"]["final_state_mse"] == te["final_state_mse"]
