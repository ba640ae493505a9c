"""Optimizer steps of `ControlTraining` against the JAX package's: the
parameters, Adam's moments and the counts after the steps
(`tests/test_torch_control.py`'s apps and tolerances). In a file of their
own, of at most five tests, because their JAX compiles are the slowest of
that file's.
"""

import numpy as np
import torch

import jax

from pde_control_tpu_torch import params_from_flax

from test_torch_control import (
    _OPT,
    _batch,
    _cached,
    _jax_app,
    _torch_app,
)


def _optimizer_case():
    """Three steps on both sides from the same (unperturbed) weights, the
    second batch holding a NaN."""
    def make():
        japp = _jax_app(**_OPT)
        tapp = _torch_app(jax.device_get(japp.params), **_OPT)
        bad = _batch(2)
        bad["obs"][0, -1, 3, 3, 0] = np.nan
        jm, tm, norms = [], [], []
        for batch in (_batch(1), bad, _batch(3)):
            jm.append(jax.device_get(japp.progress(batch)))
            tm.append(tapp.progress(batch))
            norms.append(float(torch.sqrt(sum(
                (p.grad ** 2).sum() for p in tapp.trainable))))
        return japp, tapp, jm, tm, norms
    return _cached("optimizer", make)


def _jax_adam(japp):
    state = japp.opt_state
    adam, sched = state.inner_state.inner_states["train"].inner_state[1]

    def trained(tree):
        return params_from_flax({k: v for k, v in jax.device_get(tree).items()
                                 if k in _OPT["trainable_networks"]})
    return state, adam, sched, trained(adam.mu), trained(adam.nu)


def test_optimizer_steps_match_jax_parameters():
    japp, tapp, _, _, norms = _optimizer_case()
    assert max(norms) > _OPT["grad_clip"]  # the clip acts
    jparams = params_from_flax(jax.device_get(japp.params))
    for net, sd in jparams.items():
        for k, v in sd.items():
            np.testing.assert_allclose(tapp.nets[net].state_dict()[k].numpy(),
                                       v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=f"{net}.{k}")


def test_optimizer_steps_match_jax_moments():
    japp, tapp, _, _, _ = _optimizer_case()
    _, _, _, jmu, jnu = _jax_adam(japp)
    moments = tapp.moments()
    assert set(moments) == set(jmu)
    for net in jmu:
        for k in jmu[net]:
            for got, want in zip(moments[net][k], (jmu[net][k], jnu[net][k])):
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                           atol=1e-6, err_msg=f"{net}.{k}")


def test_optimizer_steps_match_jax_counts():
    """Both of optax's counts (Adam's and the schedule's) stand at the two
    applied updates, and so does the port's one count; the counters agree
    after every step."""
    japp, tapp, jm, tm, _ = _optimizer_case()
    state, adam, sched, _, _ = _jax_adam(japp)
    assert int(adam.count) == int(sched.count) == int(tapp.optimizer.count) == 2
    for j, t in zip(jm, tm):
        for key in ("notfinite_total", "notfinite_consec"):
            assert int(j[key]) == int(t[key]), key
    assert [int(t["notfinite_consec"]) for t in tm] == [0, 1, 0]
    assert int(state.total_notfinite) == int(tapp.notfinite_total) == 1
