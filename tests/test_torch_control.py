"""The rest of the training step against the JAX package's `ControlTraining`,
on the CPU.

At 16², n=4, batch 2, buoyancy control on the bench plate, pressure tol
1e-6, fp32 nets narrowed as `test_torch_training.py` narrows them
(U-nets of 2 levels), weights converted by `params_from_flax`, inputs
from a numpy seed; `fused='auto'` on both sides. Held to:
* (a) the 'refined', 'chain_final' and 'op_supervised' classes: the loss
  at rtol 1e-4 and every trainable network's gradient at relative norm
  error 1e-3, the CFE's output layer perturbed so that every net has one;
* (b) `infer_all_frames(keep_states=True, keep_forces=True)` of 'refined':
  every returned array within 1e-5 (absolute and relative);
* (c) three steps of clipped, cosine-scheduled Adam on 'refined' (CFE and
  OP4 trainable, OP2 frozen) against three `progress` calls of the JAX
  app from the same weights, the second batch non-finite: parameters,
  both moments and the counts within 1e-6, the not-finite counters
  equal, and the clip acting in a step (in
  `tests/test_torch_control_optimizer.py`, a file of at most five tests,
  which the test run hands out last);
* (d) `progress_multi` on the CPU: bit for bit what K `progress` calls
  give;
* (e) the constructor's errors: the JAX package's messages.
Plus the pieces on their own: `run_refined` with stand-in functions, the
cosine schedule and the clip against optax, the divergence abort, and the
conv launches of a 'refined' iteration.
"""

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
from pde_control_tpu_torch.control._adam import ClippedAdam

torch.set_num_threads(1)

H, N, B = 16, 4, 2
_CFG = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-6, pressure_maxiter=500,
            warm_start_pressure=True)
_PDE = dict(control="buoyancy", unet_levels=2, cfe_features=(32, 64, 64, 32),
            op_base_features=16)
# (a)'s classes and the networks each trains.
_CLASSES = {"refined": ("CFE", "OP4", "OP2"), "chain_final": ("CFE",),
            "op_supervised": ("OP4", "OP2")}
# (c): clip and schedule; OP2 frozen, so the clip's norm must leave its
# gradients out.
_OPT = dict(sequence_class="refined", trainable_networks=("CFE", "OP4"),
            grad_clip=0.05, lr_schedule="cosine", decay_steps=4)


def _plate():
    m = np.zeros((H, H), np.float32)
    m[H // 2, H // 4:H // 2] = 1.0
    return m


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": rng.uniform(0, 1, size=(B, N + 1, H, H, 1)).astype(np.float32),
            "vy0": np.zeros((B, H + 1, H), np.float32),
            "vx0": np.zeros((B, H, H + 1), np.float32)}


def _jax_app(**app):
    jpde = JPDE(JDomain.create(H, H, obstacle_mask=jnp.asarray(_plate())),
                JConfig(**_CFG), dtype=jnp.float32, **_PDE)
    return JApp(N, jpde, batch_size=B, **app).prepare()


def _torch_app(params, **app):
    tpde = IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=_plate(), device="cpu"),
        FluidConfig(**_CFG), dtype=torch.float32, **_PDE)
    tapp = ControlTraining(N, tpde, **app).prepare()
    tapp.load_params(params_from_flax(params))
    return tapp


def _perturbed(params):
    """A nonzero CFE output layer, so that the force path carries gradient."""
    params = jax.tree_util.tree_map(np.array, params)
    k = params["CFE"]["Conv_4"]["kernel"]
    params["CFE"]["Conv_4"]["kernel"] = (
        0.05 * np.random.default_rng(3).normal(size=k.shape)).astype(np.float32)
    return params


_CACHE = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


# ------------------------------------------------------------ (a) classes

def _class_case(cls):
    """Loss and gradients of both sides for `cls`, on the same weights."""
    def make():
        japp = _jax_app(sequence_class=cls, trainable_networks=_CLASSES[cls])
        params = _perturbed(jax.device_get(japp.params))
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            japp._loss_fn, has_aux=True))(params, _batch())
        tapp = _torch_app(params, sequence_class=cls,
                          trainable_networks=_CLASSES[cls])
        tloss = tapp.evaluate(_batch())["loss"]
        tapp.compute_gradients(tapp.to_batch(_batch()))
        tgrads = {name: {k: p.grad.clone() for k, p in
                         tapp.nets[name].named_parameters()}
                  for name in _CLASSES[cls]}
        return dict(jloss=float(jloss), tloss=tloss, tgrads=tgrads,
                    jgrads=params_from_flax(jax.device_get(jgrads)))
    return _cached(("class", cls), make)


def _check_class_loss(cls):
    r = _class_case(cls)
    assert np.isfinite(r["tloss"])
    np.testing.assert_allclose(r["tloss"], r["jloss"], rtol=1e-4)


def _check_class_gradients(cls, net):
    r = _class_case(cls)
    tg = torch.cat([g.reshape(-1) for g in r["tgrads"][net].values()])
    jg = torch.cat([r["jgrads"][net][k].reshape(-1) for k in r["tgrads"][net]])
    assert float(jg.norm()) > 0
    assert float((tg - jg).norm() / jg.norm()) < 1e-3


# 'refined', the slowest class to compile, is held in
# tests/test_torch_control_refined.py, a file of at most five tests.
_HERE = [c for c in _CLASSES if c != "refined"]


@pytest.mark.parametrize("cls", _HERE)
def test_class_loss_matches_jax(cls):
    _check_class_loss(cls)


@pytest.mark.parametrize("cls,net", [(c, n) for c in _HERE
                                     for n in _CLASSES[c]])
def test_class_gradients_match_jax(cls, net):
    _check_class_gradients(cls, net)


# ----------------------------------------------------- (b) infer_all_frames

def _infer_case():
    def make():
        japp = _jax_app(sequence_class="refined")
        params = _perturbed(jax.device_get(japp.params))
        japp.params = params
        jout = jax.device_get(japp.infer_all_frames(
            _batch(1), keep_states=True, keep_forces=True))
        tout = _torch_app(params, sequence_class="refined").infer_all_frames(
            _batch(1), keep_states=True, keep_forces=True)
        return jout, tout
    return _cached("infer", make)


def _fields(x):
    """The arrays of a result in a fixed order: a tensor or an array, or a
    state or force's fields by name (velocity, density, pressure)."""
    if hasattr(x, "shape"):
        return {"": np.asarray(x)}
    out = {}
    for name in ("velocity", "density", "inflow", "pressure", "vy", "vx"):
        v = getattr(x, name, None)
        if v is not None:
            out.update({f"{name}.{k}".rstrip("."): a
                        for k, a in _fields(v).items()})
    return out


@pytest.mark.parametrize("part", ["obs_traj", "costs", "final", "states",
                                  "forces"])
def test_infer_all_frames_matches_jax(part):
    jout, tout = _infer_case()
    i = ["obs_traj", "costs", "final", "states", "forces"].index(part)
    assert len(jout) == len(tout) == 5
    want, got = _fields(jout[i]), _fields(tout[i])
    assert set(want) == set(got) and want
    for name, a in want.items():
        assert got[name].shape == a.shape, name
        np.testing.assert_allclose(np.asarray(got[name]), a, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    if part == "forces":  # the perturbed CFE acts
        assert np.abs(want["vy"]).max() > 0


# ------------------------------------------------------------ (c) the optimizer

# --------------------------------------------------------- (d) progress_multi

def test_progress_multi_on_the_cpu_equals_progress_calls():
    """K = 3 steps of 'refined' with clip and schedule, the second batch
    non-finite: one `progress_multi` call against three `progress` calls
    from the same state, bit for bit."""
    params = jax.device_get(_jax_app(**_OPT).params)
    one, multi = _torch_app(params, **_OPT), _torch_app(params, **_OPT)
    batches = [_batch(1), _batch(2), _batch(3)]
    batches[1]["obs"][1, 2, 5, 5, 0] = np.inf
    eager = [one.progress(b) for b in batches]
    stacked = multi.progress_multi(
        {k: np.stack([b[k] for b in batches]) for k in batches[0]})
    assert multi.step_count == one.step_count == 3
    assert set(stacked) == set(eager[0])
    for key, v in stacked.items():
        assert torch.equal(v, torch.stack([m[key] for m in eager]))
    for a, b in zip(one._state(), multi._state()):
        assert torch.equal(a, b)
    assert torch.equal(one.optimizer.mu, multi.optimizer.mu)


# ------------------------------------------------------------ (e) constructor

@pytest.mark.parametrize("kw", [
    dict(n=N, sequence_class="nope"),
    dict(n=6, sequence_class="refined"),
    dict(n=6, sequence_class="op_supervised"),
    dict(n=N, lr_schedule="cosine"),
    dict(n=N, refined_impl="loop"),
], ids=["class", "refined-n", "op-supervised-n", "cosine", "refined-impl"])
def test_constructor_errors_match_jax(kw):
    kw = dict(kw)
    n = kw.pop("n")
    jpde = JPDE(JDomain.create(H, H), JConfig(**_CFG), dtype=jnp.float32,
                **_PDE)
    tpde = IncompressibleFluidPDE(Domain2D.create(H, H, device="cpu"),
                                  FluidConfig(**_CFG), dtype=torch.float32,
                                  **_PDE)
    with pytest.raises(ValueError) as jerr:
        JApp(n, jpde, **kw)
    with pytest.raises(ValueError) as terr:
        ControlTraining(n, tpde, **kw)
    assert str(terr.value) == str(jerr.value)


def test_chains_take_any_horizon():
    """Only the binary subdivisions need n a power of two."""
    tpde = IncompressibleFluidPDE(Domain2D.create(H, H, device="cpu"),
                                  FluidConfig(**_CFG), dtype=torch.float32)
    for cls in ("chain", "chain_final"):
        assert ControlTraining(6, tpde, sequence_class=cls).op_spans == []
    app = ControlTraining(8, tpde, sequence_class="refined", refined_impl="auto")
    assert app.op_spans == [8, 4, 2] and app.refined_impl == "unrolled"
    assert ControlTraining(32, tpde, sequence_class="refined").refined_impl == "scan"


# ------------------------------------------------------------- the pieces

def test_run_refined_matches_jax(rng):
    """The recursion's order of steps and predictions, the stacked aux
    and states, with stand-in step and OP functions."""
    from pde_control_tpu.control.sequences import run_refined as j_run
    from pde_control_tpu_torch.control.sequences import run_refined as t_run

    s0, tgt = (rng.normal(size=(2, 4, 4, 1)).astype(np.float32)
               for _ in range(2))

    def runs(xp, run, wrap):
        def step(s, t):
            nxt = 0.7 * s + 0.3 * t
            return nxt, {"cost": xp.sum(nxt, axis=(1, 2, 3)) if xp is jnp
                         else nxt.sum(dim=(1, 2, 3))}

        def op(span, a, b):
            return 0.5 * (a + b) + 0.01 * span

        return run(step, op, lambda s: 2.0 * s, wrap(s0), wrap(tgt), 8,
                   keep_states=True)

    jout = runs(jnp, j_run, jnp.asarray)
    tout = runs(torch, t_run, torch.from_numpy)
    for a, b in ((jout[0], tout[0]), (jout[1], tout[1]),
                 (jout[2]["cost"], tout[2]["cost"]), (jout[3], tout[3])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    assert tout[1].shape == (8, 2, 4, 4, 1)
    with pytest.raises(ValueError, match="power of two"):
        t_run(None, None, None, None, None, 6)


def test_cosine_schedule_matches_optax():
    schedule = optax.cosine_decay_schedule(1e-3, 10, alpha=0.1)
    adam = ClippedAdam(1, "cpu", 1e-3, decay_steps=10)
    for count in range(13):
        got = adam.learning_rate_at(torch.tensor(count, dtype=torch.int32))
        np.testing.assert_allclose(float(got), float(schedule(count)),
                                   rtol=1e-6)


@pytest.mark.parametrize("scale", [0.5, 5.0])
def test_clipped_adam_matches_optax(rng, scale):
    """Two updates of clip_by_global_norm(1.0) → adam(1e-3) on one flat
    vector, the clip idle (norm below 1) and acting (above)."""
    g = [(scale * rng.normal(size=40) / np.sqrt(40)).astype(np.float32)
         for _ in range(2)]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    state = tx.init(jnp.zeros(40))
    adam = ClippedAdam(40, "cpu", 1e-3, grad_clip=1.0)
    for gi in g:
        want, state = tx.update(jnp.asarray(gi), state)
        got = adam.update(torch.from_numpy(gi))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-9)


def test_skipped_update_keeps_the_state():
    adam = ClippedAdam(3, "cpu", 1e-3, grad_clip=1.0, decay_steps=5)
    adam.update(torch.tensor([0.1, -0.2, 0.3]))
    before = [t.clone() for t in (adam.mu, adam.nu, adam.count)]
    step = adam.update(torch.tensor([0.1, float("nan"), 0.3]),
                       applied=torch.tensor(False))
    assert torch.equal(step, torch.zeros(3))
    for a, b in zip((adam.mu, adam.nu, adam.count), before):
        assert torch.equal(a, b)


def test_check_divergence():
    tpde = IncompressibleFluidPDE(Domain2D.create(H, H, device="cpu"),
                                  FluidConfig(**_CFG))
    app = ControlTraining(N, tpde, divergence_abort=3)
    app.step_count = 0
    app._check_divergence({"notfinite_consec": 2.0, "notfinite_total": 5.0})
    with pytest.raises(RuntimeError, match="3 consecutive"):
        app._check_divergence({"notfinite_consec": 3.0, "notfinite_total": 5.0})
    ControlTraining(N, tpde, divergence_abort=0)._check_divergence(
        {"notfinite_consec": 1e9})


def test_refined_conv_launches_per_iteration(monkeypatch):
    """With conv_impl='cuda' (K4/K5's plain versions on CPU tensors) a
    'refined' iteration calls the conv once per 3×3 stride-1 conv of its
    n CFE calls and n − 1 single OP calls, forward and dW, and dX for all
    but the first OP call's first conv, whose input is the ground truth:
    n·(len(CFE widths) + 1) + (n − 1)·(5·levels + 2)."""
    from pde_control_tpu_torch.ops import cuda_conv

    calls = {"forward": 0, "dx": 0, "dw": 0}
    for d in calls:
        fn = getattr(cuda_conv, f"conv3x3_{d}")
        monkeypatch.setattr(cuda_conv, f"conv3x3_{d}", lambda *a, _f=fn, _d=d:
                            calls.__setitem__(_d, calls[_d] + 1) or _f(*a))
    tpde = IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=_plate(), device="cpu"),
        FluidConfig(**_CFG, fused="cuda"), dtype=torch.bfloat16,
        conv_impl="cuda", **_PDE)
    app = ControlTraining(N, tpde, sequence_class="refined",
                          trainable_networks=("CFE", "OP4", "OP2")).prepare()
    app.progress(_batch())
    fwd = N * (len(_PDE["cfe_features"]) + 1) + (N - 1) * (
        5 * _PDE["unet_levels"] + 2)
    assert calls == {"forward": fwd, "dx": fwd - 1, "dw": fwd}
