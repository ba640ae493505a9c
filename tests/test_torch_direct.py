"""BASELINE configs 3 and 5 through the port's training, on the CPU.

Against the JAX package at 16², batch 2, fp32 nets (CFE 8-16, U-nets of 2
levels, base width 4), the CFE's output layer perturbed so that every net
has a gradient, weights converted by `params_from_flax`, pressure tol
1e-6:
* one iteration of the staggered class with the direct two-channel force
  (config 3's physics, n=4, every net trainable): the loss at rtol 1e-4
  and each network's gradient at relative norm error 1e-3, the tolerances
  of `tests/test_torch_control.py`;
* the 'refined' class at n=8 (config 5's physics, observation frames
  2/4/6/8, every net trainable) against the JAX package's
  `refined_impl='scan'`, the scheme it runs from n=32 on: the same
  tolerances.
On the port alone: the entries' `CurriculumConfig`s equal the JAX
package's (config 5's horizons 32 → 64 → 128 and frames 32/64/96/128
included), the e2e stages' frames and the 7-level OP hierarchy at n=128,
and `run shape_transition` and `run natural_flow_128` with `--smoke-test
--device cpu --iterations 2`. The two cases' tests are in
`tests/test_torch_direct_{staggered,refined}.py` (files of at most five
tests, which the test run hands out last).
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu.control.pde_fluid import IncompressibleFluidPDE as JPDE
from pde_control_tpu.control.training import ControlTraining as JApp
from pde_control_tpu.experiments import fluid2d as jfluid2d
from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.physics.fluid import FluidConfig as JConfig
from pde_control_tpu_torch import (
    ControlTraining,
    Domain2D,
    FluidConfig,
    IncompressibleFluidPDE,
    params_from_flax,
)
from pde_control_tpu_torch.experiments import curriculum, fluid2d, run

torch.set_num_threads(1)

H, B = 16, 2
_PDE = dict(control="direct", unet_levels=2, cfe_features=(8, 16),
            op_base_features=4)
_TOL = dict(pressure_tol=1e-6, pressure_maxiter=500, warm_start_pressure=True)
# case: (n, physics, ControlTraining arguments of both sides)
_CASES = {
    "direct_staggered": (4, dict(dt=1.0, buoyancy=0.0), dict(
        sequence_class="staggered",
        trainable_networks=("CFE", "OP4", "OP2"))),
    "refined_n8": (8, dict(dt=0.5, buoyancy=0.05), dict(
        sequence_class="refined", obs_loss_frames=(2, 4, 6, 8),
        trainable_networks=("CFE", "OP8", "OP4", "OP2"))),
}
_CACHE = {}


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.uniform(0, 1, size=(B, n + 1, H, H, 1)).astype(np.float32),
            "vy0": (0.05 * rng.normal(size=(B, H + 1, H))).astype(np.float32),
            "vx0": (0.05 * rng.normal(size=(B, H, H + 1))).astype(np.float32)}


def _case(name):
    if name not in _CACHE:
        n, phys, app = _CASES[name]
        jpde = JPDE(JDomain.create(H, H), JConfig(**phys, **_TOL),
                    dtype=jnp.float32, **_PDE)
        jkw = dict(refined_impl="scan") if name == "refined_n8" else {}
        japp = JApp(n, jpde, batch_size=B, **app, **jkw).prepare()
        params = jax.tree_util.tree_map(np.array, jax.device_get(japp.params))
        k = params["CFE"]["Conv_2"]["kernel"]
        params["CFE"]["Conv_2"]["kernel"] = (0.05 * np.random.default_rng(3)
                                             .normal(size=k.shape)
                                             ).astype(np.float32)
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            japp._loss_fn, has_aux=True))(params, _batch(n))
        tpde = IncompressibleFluidPDE(Domain2D.create(H, H, device="cpu"),
                                      FluidConfig(**phys, **_TOL),
                                      dtype=torch.float32, **_PDE)
        tapp = ControlTraining(n, tpde, batch_size=B, **app).prepare()
        tapp.load_params(params_from_flax(params))
        metrics = tapp.compute_gradients(tapp.to_batch(_batch(n)))
        _CACHE[name] = dict(
            jloss=float(jloss), tloss=float(metrics["loss"]),
            jgrads=params_from_flax(jax.device_get(jgrads)),
            tgrads={net: {k: p.grad.clone() for k, p in
                          tapp.nets[net].named_parameters()}
                    for net in app["trainable_networks"]})
    return _CACHE[name]


# The two cases' loss and gradient tests are in
# tests/test_torch_direct_{staggered,refined}.py, files of at most five
# tests each, because their JAX compiles take most of this file's time.
def _check_loss(name):
    r = _case(name)
    assert np.isfinite(r["tloss"])
    np.testing.assert_allclose(r["tloss"], r["jloss"], rtol=1e-4)


def _check_gradients(name, net):
    r = _case(name)
    tg = torch.cat([g.reshape(-1) for g in r["tgrads"][net].values()])
    jg = torch.cat([r["jgrads"][net][k].reshape(-1) for k in r["tgrads"][net]])
    assert float(jg.norm()) > 0
    assert float((tg - jg).norm() / jg.norm()) < 1e-3


# ------------------------------------------------- curricula of the entries

def _configs(module, entry, monkeypatch, **kw):
    """The CurriculumConfig `entry` hands to run_curriculum/finetune_e2e,
    with the task setup stubbed out."""
    got = []
    for setup in ("_shape_transition_setup", "_natural_flow_setup"):
        monkeypatch.setattr(module, setup, lambda *a, **k: (None, None, None))
    for runner in ("run_curriculum", "finetune_e2e"):
        monkeypatch.setattr(module, runner,
                            lambda pde, cfg, *a, **k: got.append(cfg) or {})
    getattr(module, entry)("unused", **kw)
    return dataclasses.asdict(got[0])


@pytest.mark.parametrize("entry, kw", [
    ("run_shape_transition", {}),
    ("run_shape_transition_ft", dict(init_from="ckpt")),
    ("run_natural_flow_128", {}),
    ("run_natural_flow_128", dict(sequence="refined", n=8)),
    ("run_natural_flow_128_ft", dict(init_from="ckpt")),
])
def test_curriculum_configs_match_jax(entry, kw, monkeypatch):
    got = _configs(fluid2d, entry, monkeypatch, **kw)
    want = _configs(jfluid2d, entry, monkeypatch, **kw)
    assert got == {k: want[k] for k in got}


def test_config5_stages_frames_and_hierarchy(monkeypatch):
    cfg = curriculum.CurriculumConfig(
        **_configs(fluid2d, "run_natural_flow_128", monkeypatch))
    assert cfg.e2e_stage_ns == (32, 64, 128)
    assert [curriculum._e2e_frames(cfg, n) for n in cfg.e2e_stage_ns] == [
        (32,), (32, 64), (32, 64, 96, 128)]
    assert curriculum.op_spans(128) == [128, 64, 32, 16, 8, 4, 2]
    app = ControlTraining(128, object(), sequence_class="refined",
                          device="cpu")
    assert app.op_spans == [128, 64, 32, 16, 8, 4, 2]
    assert app.refined_impl == "scan"  # the JAX package's choice at n ≥ 32


# ---------------------------------------------------------------------- CLI

@pytest.mark.parametrize("name, stages", [
    ("shape_transition", ("cfe_supervised", "op2_supervised",
                          "op4_supervised", "end_to_end_n4")),
    ("natural_flow_128", ("cfe_supervised", "op2_supervised",
                          "op4_supervised", "op8_supervised",
                          "end_to_end_n8")),
])
def test_cli_on_the_cpu(tmp_path, name, stages):
    wd = str(tmp_path / name)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        run.main([name, "--smoke-test", "--device", "cpu", "--iterations",
                  "2", "--workdir", wd])
    with open(os.path.join(wd, "results.json")) as f:
        res = json.load(f)
    assert json.loads(out.getvalue())["eval"] == res["eval"]
    for key in stages + ("end_to_end", "eval"):
        assert key in res, key
    ev = res["eval"]
    assert np.isfinite(ev["final_state_mse"]) and ev["zero_force_final_mse"] > 0
    assert ev["mean_abs_force"] > 0  # the direct force acts
    assert res["end_to_end"]["iterations_run"] == 8  # 2, rounded up to K = 8
