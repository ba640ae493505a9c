"""The slice as a whole: the port's training iteration against the JAX
package's, on the same weights and batch.

`ControlTraining` at 16², n=4, batch 2, staggered OP tree (OP4, OP2) and
CFE, buoyancy control on the bench plate, pressure tol 1e-6, fp32 nets on
weights converted by `params_from_flax`. Held to: the loss at rtol 1e-4,
each network's gradient at relative norm error 1e-3, the parameters after
one Adam step at atol 1e-6; with bf16 nets, the loss at rtol 2e-2.
"""

import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu.control.pde_fluid import IncompressibleFluidPDE as JPDE
from pde_control_tpu.control.training import ControlTraining as JApp
from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.physics.fluid import FluidConfig as JConfig
from pde_control_tpu_torch import (
    ControlTraining,
    Domain2D,
    FluidConfig,
    IncompressibleFluidPDE,
    params_from_flax,
)

torch.set_num_threads(1)

H, N, B = 16, 4, 2
NETS = ("CFE", "OP4", "OP2")


def _plate():
    m = np.zeros((H, H), np.float32)
    m[H // 2, H // 4:H // 2] = 1.0
    return m


def _batch(seed=0):
    """`__graft_entry__._make_batch` at the test's size."""
    rng = np.random.default_rng(seed)
    return {"obs": rng.uniform(0, 1, size=(B, N + 1, H, H, 1)).astype(np.float32),
            "vy0": np.zeros((B, H + 1, H), np.float32),
            "vx0": np.zeros((B, H, H + 1), np.float32)}


_CFG = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-6, pressure_maxiter=500,
            warm_start_pressure=True)
_PDE = dict(control="buoyancy", unet_levels=2, cfe_features=(32, 64, 64, 32),
            op_base_features=16)
_APP = dict(trainable_networks=NETS, sequence_class="staggered",
            obs_loss_frames=(N,))


_JAX = {}


def _jax_app(bf16: bool):
    """The JAX package's app, its jitted loss and its loss-and-gradient,
    built once per net dtype; parameters go in as arguments."""
    if bf16 not in _JAX:
        jpde = JPDE(JDomain.create(H, H, obstacle_mask=jnp.asarray(_plate())),
                    JConfig(**_CFG), dtype=jnp.bfloat16 if bf16 else jnp.float32,
                    **_PDE)
        japp = JApp(N, jpde, batch_size=B, **_APP).prepare()
        _JAX[bf16] = (japp, jax.jit(japp._loss_fn),
                      jax.jit(jax.value_and_grad(japp._loss_fn, has_aux=True)))
    return _JAX[bf16]


def _apps(bf16: bool, perturb_cfe: bool, fused: str = "auto"):
    """(JAX app, its parameters, the port's app on the same weights); the
    port's step fused or not (the JAX package's tests pin its fused step
    to the unfused one, so the JAX side is always unfused)."""
    japp = _jax_app(bf16)[0]
    params = jax.device_get(japp.params)
    if perturb_cfe:
        # A nonzero CFE output layer, so the force path carries gradient.
        rng = np.random.default_rng(3)
        params = jax.tree_util.tree_map(np.array, params)
        k = params["CFE"]["Conv_4"]["kernel"]
        params["CFE"]["Conv_4"]["kernel"] = (
            0.05 * rng.normal(size=k.shape)).astype(np.float32)
    tpde = IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=_plate(), device="cpu"),
        FluidConfig(**_CFG, fused=fused),
        dtype=torch.bfloat16 if bf16 else torch.float32, **_PDE)
    tapp = ControlTraining(N, tpde, **_APP).prepare()
    tapp.load_params(params_from_flax(params))
    return japp, params, tapp


_JAX_STEP = {}
_RESULTS = {}


def _jax_step(perturb_cfe: bool):
    """The JAX side's loss, gradients and one Adam step (cached per case)."""
    if perturb_cfe not in _JAX_STEP:
        japp, params, _ = _apps(False, perturb_cfe)
        (jloss, _), jgrads = _jax_app(False)[2](params, _batch())
        updates, _ = japp.optimizer.update(jgrads, japp.optimizer.init(params),
                                           params)
        jparams = jax.device_get(optax.apply_updates(params, updates))
        _JAX_STEP[perturb_cfe] = dict(
            jloss=float(jloss), jgrads=params_from_flax(jax.device_get(jgrads)),
            jparams=params_from_flax(jparams))
    return _JAX_STEP[perturb_cfe]


def _step(perturb_cfe: bool, fused: str = "auto"):
    """Loss, gradients and one Adam step on both sides (cached per case)."""
    if (perturb_cfe, fused) not in _RESULTS:
        _, _, tapp = _apps(False, perturb_cfe, fused)
        tmetrics = tapp.progress(_batch())
        tgrads = {name: {k: p.grad.clone() for k, p in
                         tapp.nets[name].named_parameters()} for name in NETS}
        _RESULTS[perturb_cfe, fused] = dict(
            _jax_step(perturb_cfe), tloss=float(tmetrics["loss"]),
            tgrads=tgrads,
            tparams={name: tapp.nets[name].state_dict() for name in NETS},
            tmetrics=tmetrics)
    return _RESULTS[perturb_cfe, fused]


@pytest.mark.parametrize("perturb_cfe", [False, True])
def test_loss_matches_jax(perturb_cfe):
    _check_loss(_step(perturb_cfe))


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("perturb_cfe", [False, True])
def test_gradients_match_jax(perturb_cfe, net):
    _check_gradients(_step(perturb_cfe), net, perturb_cfe)


@pytest.mark.parametrize("perturb_cfe", [False, True])
def test_fused_loss_matches_jax(perturb_cfe):
    """The slice with the whole-step kernels' route (`fused='cuda'`, their
    plain versions on CPU tensors) against the JAX package's unfused
    iteration."""
    _check_loss(_step(perturb_cfe, "cuda"))


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("perturb_cfe", [False, True])
def test_fused_gradients_match_jax(perturb_cfe, net):
    _check_gradients(_step(perturb_cfe, "cuda"), net, perturb_cfe)


def _check_loss(r):
    assert np.isfinite(r["tloss"])
    np.testing.assert_allclose(r["tloss"], r["jloss"], rtol=1e-4)


def _check_gradients(r, net, perturb_cfe):
    tg = torch.cat([g.reshape(-1) for g in r["tgrads"][net].values()])
    jg = torch.cat([r["jgrads"][net][k].reshape(-1) for k in r["tgrads"][net]])
    if net != "CFE" and not perturb_cfe:
        # The CFE's output layer starts at zero, so no gradient reaches the
        # OP nets through the targets it is fed: exactly zero on both sides.
        assert float(jg.abs().max()) == 0.0 and float(tg.abs().max()) == 0.0
        return
    assert float((tg - jg).norm() / jg.norm()) < 1e-3


def _assert_params_close(tparams, jparams):
    for net in NETS:
        for k, v in tparams[net].items():
            np.testing.assert_allclose(v.numpy(), jparams[net][k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=f"{net}.{k}")


def test_adam_step_matches_jax():
    """The main path's first iteration: each side steps on its own
    gradients."""
    r = _step(False)
    _assert_params_close(r["tparams"], r["jparams"])
    assert r["tmetrics"]["notfinite_total"] == 0


def test_fused_adam_step_matches_jax():
    r = _step(False, "cuda")
    _assert_params_close(r["tparams"], r["jparams"])
    assert r["tmetrics"]["notfinite_total"] == 0


@pytest.mark.parametrize("perturb_cfe", [False, True])
def test_adam_step_on_jax_gradients(perturb_cfe):
    """The port's update (`apply_gradients`) fed JAX's gradients. With a
    live force path some gradient entries fall to |g| ~ Adam's ε = 1e-8,
    where the first step, lr·g/(|g|+ε), turns the gradients' 1e-3
    agreement into more than 1e-6 in the parameters; so the step itself is
    held to 1e-6 on identical gradients."""
    r = _step(perturb_cfe)
    _, _, tapp = _apps(False, perturb_cfe)
    for name in NETS:
        for k, p in tapp.nets[name].named_parameters():
            p.grad = r["jgrads"][name][k].clone()
    assert tapp.apply_gradients()
    _assert_params_close({n: tapp.nets[n].state_dict() for n in NETS},
                         r["jparams"])


def test_bf16_loss_matches_jax():
    _, params, tapp = _apps(True, True)
    batch = _batch(1)
    jloss, _ = _jax_app(True)[1](params, batch)
    tloss = tapp.evaluate(batch)["loss"]
    np.testing.assert_allclose(tloss, float(jloss), rtol=2e-2)


def _no_adam_step(tapp) -> bool:
    """Adam's count and moments are still at their initial zeros."""
    opt = tapp.optimizer
    return int(opt.count) == 0 and not opt.mu.any() and not opt.nu.any()


def test_adam_update_equals_optax(rng):
    """The port's Adam (`control/_adam.py`) and optax.adam give the same
    parameters over three steps of the same gradients."""
    from pde_control_tpu_torch.control._adam import ClippedAdam

    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    tx = optax.adam(1e-3)
    jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.from_numpy(p0.copy()).reshape(-1)
    opt = ClippedAdam(tp.numel(), "cpu", 1e-3)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp += opt.update(torch.from_numpy(g).reshape(-1))
    np.testing.assert_allclose(tp.reshape(p0.shape).numpy(), np.asarray(jp),
                               rtol=0, atol=1e-6)


def test_nonfinite_update_is_skipped():
    _, _, tapp = _apps(False, False)
    before = {k: v.clone() for k, v in tapp.nets["OP4"].state_dict().items()}
    batch = _batch()
    batch["obs"][0, -1, 0, 0, 0] = np.nan
    m = tapp.progress(batch)
    assert m["notfinite_total"] == 1 and m["notfinite_consec"] == 1
    for k, v in tapp.nets["OP4"].state_dict().items():
        assert torch.equal(v, before[k])
    assert _no_adam_step(tapp)


def test_nonfinite_frozen_gradient_skips_the_update():
    """A non-finite gradient in a frozen network only: the JAX package's
    `apply_if_finite` sees the whole gradient tree and skips the step, and
    so does the port. Both count 1 and leave parameters and Adam's state as
    they were. The port computes the frozen networks' gradients of the
    loss for the check and drops them after it."""
    jpde = JPDE(JDomain.create(H, H, obstacle_mask=jnp.asarray(_plate())),
                JConfig(**_CFG), dtype=jnp.float32, **_PDE)
    app_kw = dict(_APP, trainable_networks=("CFE",))
    japp = JApp(N, jpde, batch_size=B, **app_kw).prepare()
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(japp.params))
    rng = np.random.default_rng(7)
    grads = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params)
    grads["OP4"]["Conv_0"]["kernel"][0, 0, 0, 0] = np.nan
    updates, state = japp.optimizer.update(
        jax.tree_util.tree_map(jnp.asarray, grads), japp.opt_state, japp.params)
    assert int(state.notfinite_count) == 1 and int(state.total_notfinite) == 1
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(optax.apply_updates(params, updates)),
        jax.tree_util.tree_leaves(params)))
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(state.inner_state),
        jax.tree_util.tree_leaves(japp.opt_state.inner_state)))

    tpde = IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=_plate(), device="cpu"),
        FluidConfig(**_CFG), dtype=torch.float32, **_PDE)
    tapp = ControlTraining(N, tpde, **app_kw).prepare()
    tapp.load_params(params_from_flax(params))
    before = {n: {k: v.clone() for k, v in tapp.nets[n].state_dict().items()}
              for n in NETS}
    tgrads = params_from_flax(grads)
    for name, net in tapp.nets.items():
        for key, p in net.named_parameters():
            p.grad = tgrads[name][key].clone()
    assert not tapp.apply_gradients()
    assert tapp.notfinite_total == 1 and tapp.notfinite_consec == 1
    assert _no_adam_step(tapp)
    for n in NETS:
        assert all(torch.equal(v, before[n][k])
                   for k, v in tapp.nets[n].state_dict().items())
    frozen = [p for n in ("OP4", "OP2") for p in tapp.nets[n].parameters()]
    assert all(p.grad is None for p in frozen)

    tapp.compute_gradients(tapp.to_batch(_batch()))
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in frozen)
    assert tapp.apply_gradients() and tapp.notfinite_consec == 0
    assert all(p.grad is None for p in frozen)


def test_frozen_network_gets_no_update():
    tpde = IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=_plate(), device="cpu"), FluidConfig(**_CFG),
        dtype=torch.float32, **_PDE)
    app = ControlTraining(N, tpde, **dict(_APP, trainable_networks=("CFE",)))
    app.prepare()
    before = {n: {k: v.clone() for k, v in app.nets[n].state_dict().items()}
              for n in NETS}
    app.progress(_batch())
    for n in ("OP4", "OP2"):
        assert all(torch.equal(v, before[n][k])
                   for k, v in app.nets[n].state_dict().items())
        assert all(p.grad is None for p in app.nets[n].parameters())
    assert any(not torch.equal(v, before["CFE"][k])
               for k, v in app.nets["CFE"].state_dict().items())


def test_import_leaves_jax_out():
    """Every module of the port, and `chip_smoke.py`, imports none of jax,
    flax, optax, msgpack or the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import importlib, pkgutil, sys, pde_control_tpu_torch, chip_smoke; "
            "mods = [m.name for m in pkgutil.walk_packages("
            "pde_control_tpu_torch.__path__, 'pde_control_tpu_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "assert len(mods) >= 30, mods; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'msgpack', 'pde_control_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120, cwd=env["PYTHONPATH"])


def test_solves_per_iteration(monkeypatch):
    """backend='cuda' (the kernel's plain version on CPU tensors) solves n
    times warm in the forward pass and n-1 times cold in the backward: the
    last step's velocity never reaches the final-frame loss, so autograd
    runs no backward solve for it."""
    from pde_control_tpu_torch.ops import cuda_cg

    calls = []
    plain = cuda_cg.pcg_plain

    def counting(*args, **kw):
        calls.append("warm" if kw.get("x0", args[4] if len(args) > 4 else None)
                     is not None else "cold")
        return plain(*args, **kw)

    monkeypatch.setattr(cuda_cg, "pcg_plain", counting)
    tpde = IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=_plate(), device="cpu"),
        FluidConfig(**dict(_CFG, pressure_backend="cuda")),
        dtype=torch.float32, **_PDE)
    app = ControlTraining(N, tpde, **_APP).prepare()
    app.progress(_batch())
    assert calls.count("warm") == N and calls.count("cold") == N - 1


def test_fused_steps_per_iteration(monkeypatch):
    """fused='cuda' (the kernels' plain versions on CPU tensors) runs one
    forward and one backward per step, the last step's backward included:
    the final-frame loss reads that step's density. No separate solve."""
    from pde_control_tpu_torch.ops import cuda_cg, cuda_fluid

    calls = []
    for name in ("fused_step_plain_forward", "fused_step_plain_backward"):
        fn = getattr(cuda_fluid, name)
        monkeypatch.setattr(cuda_fluid, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    monkeypatch.setattr(cuda_cg, "pressure_solve", None)  # never reached
    tpde = IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=_plate(), device="cpu"),
        FluidConfig(**_CFG, fused="cuda"), dtype=torch.float32, **_PDE)
    app = ControlTraining(N, tpde, **_APP).prepare()
    app.progress(_batch())
    assert calls.count("fused_step_plain_forward") == N
    assert calls.count("fused_step_plain_backward") == N


def test_staggered_targets_match_jax(rng):
    """The OP tree's order and batching, with a stand-in OP."""
    from pde_control_tpu.control.sequences import staggered_targets as j_st
    from pde_control_tpu_torch.control.sequences import staggered_targets as t_st

    o0, on = (rng.normal(size=(2, 4, 4, 1)).astype(np.float32) for _ in range(2))
    t = t_st(lambda s, a, b: 0.5 * (a + b) + s * a.mean(), torch.from_numpy(o0),
             torch.from_numpy(on), 8)
    j = j_st(lambda s, a, b: 0.5 * (a + b) + s * a.mean(), jnp.asarray(o0),
             jnp.asarray(on), 8)
    assert len(t) == len(j) == 9
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="power of two"):
        t_st(None, torch.from_numpy(o0), torch.from_numpy(on), 6)


def test_chain_loss_matches_jax():
    """The 'chain' class (supervised next-frame targets, no OPs) at n=2."""
    n = 2
    app_kw = dict(trainable_networks=("CFE",), sequence_class="chain")
    jpde = JPDE(JDomain.create(H, H, obstacle_mask=jnp.asarray(_plate())),
                JConfig(**_CFG), dtype=jnp.float32, **_PDE)
    japp = JApp(n, jpde, batch_size=B, **app_kw).prepare()
    params = jax.tree_util.tree_map(np.array, jax.device_get(japp.params))
    params["CFE"]["Conv_4"]["kernel"] = (0.05 * np.random.default_rng(4).normal(
        size=params["CFE"]["Conv_4"]["kernel"].shape)).astype(np.float32)
    batch = {k: v[:, :n + 1] if k == "obs" else v for k, v in _batch().items()}
    jloss, _ = jax.jit(japp._loss_fn)(params, batch)
    tpde = IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=_plate(), device="cpu"), FluidConfig(**_CFG),
        dtype=torch.float32, **_PDE)
    tapp = ControlTraining(n, tpde, **app_kw).prepare()
    tapp.load_params(params_from_flax(params))
    assert tapp.op_spans == []
    np.testing.assert_allclose(tapp.evaluate(batch)["loss"], float(jloss),
                               rtol=1e-4)
