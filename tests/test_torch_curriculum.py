"""The staged-training entry point: `ControlTraining.train`,
`finetune_e2e`, `run_curriculum` and the `run` CLI, on the CPU.

Against the JAX package, at 16², n=4, batch 2, the smoke task's obstacle
course, buoyancy control with inflow, pressure tol 1e-6, fp32 nets
narrowed (CFE 8-16, U-nets of 2 levels, base width 4), the CFE's output
layer perturbed, on one random dataset of 6 trajectories:
* `train(4, steps_per_call=2, log_every=2)` and `train(3)` (one step a
  call) of the staggered class, every net trainable, clip 1.0 and a
  cosine schedule: the same batches drawn (the seed's stream), the
  logged metrics at rtol 1e-5 (measured 2.3e-7), the final parameters at
  atol 1e-6 (measured 5.0e-7), as PR 9's Adam steps;
* `finetune_e2e` from a checkpoint the JAX package wrote, 2 iterations:
  the eval blocks at rtol 1e-5 (measured 7.9e-7; the per-frame curves at
  rtol 1e-5 / atol 1e-9), the written `ckpt_final` weights at atol 1e-6
  (measured 1.6e-7).
On the port alone, at 8² with smaller nets: the curriculum's stages and
files, `e2e_stage_ns` ending at n, resume (finished stages skipped, a
partial one restored from its autosave, every OP stage trained from
scratch), and the CLI's `--smoke-test` run on the CPU.
"""

import contextlib
import io
import json
import os
import shutil

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
from pde_control_tpu_torch import (
    ControlTraining,
    Domain2D,
    FluidConfig,
    IncompressibleFluidPDE,
    params_from_flax,
)
from pde_control_tpu_torch.data.scene import TrajectoryDataset
from pde_control_tpu_torch.experiments import curriculum, run
from pde_control_tpu_torch.experiments.curriculum import CurriculumConfig
from pde_control_tpu_torch.utils.checkpoint import load_network

torch.set_num_threads(1)

H, N, B = 16, 4, 2
NETS = ("CFE", "OP4", "OP2")
_CFG = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-6, pressure_maxiter=500,
            warm_start_pressure=True)
_PDE = dict(control="buoyancy", with_inflow=True, unet_levels=2,
            cfe_features=(8, 16), op_base_features=4)
_APP = dict(batch_size=B, trainable_networks=NETS, sequence_class="staggered",
            grad_clip=1.0, lr_schedule="cosine", decay_steps=4, seed=3)


def _arrays(num=6, seed=0, h=H, n=N):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.uniform(0, 1, size=(num, n + 1, h, h, 1)).astype(np.float32),
        vy0=(0.1 * rng.normal(size=(num, h + 1, h))).astype(np.float32),
        vx0=(0.1 * rng.normal(size=(num, h, h + 1))).astype(np.float32),
        inflow=rng.uniform(0, 0.05, size=(num, h, h)).astype(np.float32))


def _datasets(cls, seed=0, **kw):
    a = _arrays(seed=seed, **kw)
    return cls(a.pop("obs"), **a)


def _jpde():
    return JPDE(JDomain.create(H, H, obstacle_mask=jnp.asarray(
        default_obstacles(H, H))), JConfig(**_CFG), dtype=jnp.float32, **_PDE)


def _tpde():
    return IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=np.array(default_obstacles(H, H)),
                        device="cpu"),
        FluidConfig(**_CFG), dtype=torch.float32, **_PDE)


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


# ----------------------------------------------------------------- train()

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


def test_train_rounds_up_and_draws_only_from_its_stream(tmp_path):
    """train(3, steps_per_call=2) runs 4 steps, as the JAX package's does;
    evaluate() draws from the validation stream, not the training one."""
    tapp = ControlTraining(N, _tpde(), dataset=_datasets(TrajectoryDataset),
                           val_dataset=_datasets(TrajectoryDataset, seed=1),
                           **_APP).prepare()
    state = tapp._np_rng.bit_generator.state
    tapp.evaluate()
    assert tapp._np_rng.bit_generator.state == state
    res = tapp.train(3, steps_per_call=2, log_every=2, val_every=2)
    assert res["iterations_run"] == tapp.step_count == 4
    with pytest.raises(NotImplementedError, match="not ported"):
        ControlTraining(N, _tpde(), mesh=object())


# ------------------------------------------------------------ finetune_e2e

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


# --------------------------------------------------- run_curriculum, port

_SMALL = dict(control="buoyancy", with_inflow=True, unet_levels=2,
              cfe_features=(4, 4), op_base_features=2)


def _small():
    pde = IncompressibleFluidPDE(
        Domain2D.create(8, 8, obstacle_mask=np.array(default_obstacles(8, 8)),
                        device="cpu"),
        FluidConfig(dt=1.0, buoyancy=0.08, pressure_tol=1e-4,
                    pressure_maxiter=50, warm_start_pressure=True),
        dtype=torch.float32, **_SMALL)
    train = _datasets(TrajectoryDataset, h=8, num=8)
    val = _datasets(TrajectoryDataset, seed=1, h=8, num=4)
    return pde, train, val


def _ccfg(**kw):
    return CurriculumConfig(**dict(dict(
        n=N, batch_size=2, cfe_iterations=2, op_iterations=2,
        e2e_iterations=2, steps_per_call=2, autosave_every=2), **kw))


_STAGES = ("cfe_supervised", "op2_supervised", "op4_supervised",
           "end_to_end_n2", "end_to_end_n4")


def test_curriculum_stages_and_files(tmp_path):
    pde, train, val = _small()
    wd = str(tmp_path / "c")
    res = curriculum.run_curriculum(pde, _ccfg(e2e_stage_ns=(2, 4)), train,
                                    val, wd)
    for key in _STAGES + ("end_to_end", "eval"):
        assert key in res, key
    assert os.path.isdir(os.path.join(wd, "ckpt_e2e_n2"))
    assert sorted(f for f in os.listdir(os.path.join(wd, "ckpt_final"))
                  if f.endswith(".msgpack")) == [
                      "CFE.msgpack", "OP2.msgpack", "OP4.msgpack"]
    assert not [f for f in os.listdir(wd) if f.startswith("autosave")]
    ev = res["eval"]
    assert np.isfinite(ev["final_state_mse"]) and ev["zero_force_final_mse"] > 0
    np.testing.assert_allclose(ev["per_frame_mse"][-1], ev["final_state_mse"],
                               rtol=1e-5)
    assert len(ev["per_frame_mse"]) == N and ev["eval_samples"] == 4
    assert res["end_to_end"]["loss"] == res["end_to_end_n4"]["loss"]
    with open(os.path.join(wd, "results.json")) as f:
        assert "eval" in json.load(f) and "vm_epoch" in res
    assert os.path.exists(os.path.join(wd, "logs_e2e_n4", "metrics.jsonl"))
    with pytest.raises(ValueError, match="e2e_stage_ns"):
        curriculum.run_curriculum(pde, _ccfg(e2e_stage_ns=(2,)), train, val,
                                  str(tmp_path / "x"))


def test_resume_skips_finished_and_restores_a_partial_stage(tmp_path,
                                                            monkeypatch):
    pde, train, val = _small()
    wd = str(tmp_path / "c")
    first = curriculum.run_curriculum(pde, _ccfg(e2e_stage_ns=(2, 4)), train,
                                      val, wd)
    res = curriculum.run_curriculum(pde, _ccfg(e2e_stage_ns=(2, 4)), train,
                                    val, wd, resume=True)
    for key in _STAGES:
        assert res[key] == {"resumed": True}, key
    assert res["eval"]["final_state_mse"] == first["eval"]["final_state_mse"]

    # A kill after the last e2e stage's autosave, before its checkpoint.
    shutil.rmtree(os.path.join(wd, "ckpt_e2e_n4"))
    real_save = ControlTraining.save

    def killed(self, directory, names=None):
        if directory.endswith("ckpt_e2e_n4"):
            raise KeyboardInterrupt
        real_save(self, directory, names)

    monkeypatch.setattr(ControlTraining, "save", killed)
    with pytest.raises(KeyboardInterrupt):
        curriculum.run_curriculum(pde, _ccfg(e2e_stage_ns=(2, 4)), train, val,
                                  wd, resume=True)
    monkeypatch.setattr(ControlTraining, "save", real_save)
    assert os.path.exists(os.path.join(wd, "autosave_e2e_n4", "state.json"))
    res2 = curriculum.run_curriculum(pde, _ccfg(e2e_stage_ns=(2, 4)), train,
                                     val, wd, resume=True)
    assert res2["end_to_end_n2"] == {"resumed": True}
    assert res2["end_to_end_n4"] == {"resumed_mid_stage": 2,
                                     "iterations_run": 2}
    assert os.path.exists(os.path.join(wd, "ckpt_e2e_n4", "OP4.msgpack"))
    assert not os.path.exists(os.path.join(wd, "autosave_e2e_n4"))


def test_resume_from_scratch_trains_every_op_stage(tmp_path):
    pde, train, val = _small()
    wd = str(tmp_path / "fresh")
    res = curriculum.run_curriculum(pde, _ccfg(), train, val, wd, resume=True)
    for key in ("cfe_supervised", "op2_supervised", "op4_supervised"):
        assert "loss" in res[key], f"{key} was skipped on a fresh run"
    assert {f for f in os.listdir(os.path.join(wd, "ckpt_ops"))
            if f.endswith(".msgpack")} == {"OP2.msgpack", "OP4.msgpack"}


# ---------------------------------------------------------------------- CLI

def test_cli_smoke_indirect_on_the_cpu(tmp_path):
    wd = str(tmp_path / "run")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        run.main(["smoke_indirect", "--smoke-test", "--device", "cpu",
                  "--workdir", wd])
    with open(os.path.join(wd, "results.json")) as f:
        res = json.load(f)
    assert json.loads(out.getvalue())["eval"] == res["eval"]
    for key in ("cfe_supervised", "op2_supervised", "op4_supervised",
                "end_to_end", "eval"):
        assert key in res, key
    assert np.isfinite(res["eval"]["final_state_mse"])
    assert res["end_to_end"]["iterations_run"] == 16


@pytest.mark.parametrize("argv, message", [
    (["shape_transition"], "shape_transition is not ported yet"),
    (["smoke_indirect", "--sequence", "refined"], "--sequence is not supported"),
    (["smoke_indirect", "--mesh", "4"], "--mesh"),
    (["smoke_indirect_ft"], "requires --init-from"),
])
def test_cli_refuses(argv, message, capsys):
    with pytest.raises(SystemExit):
        run.main(argv + ["--device", "cpu"])
    assert message in capsys.readouterr().err
