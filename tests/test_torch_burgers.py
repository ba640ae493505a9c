"""The Burgers slice (BASELINE configs 1-2) against the JAX package, on
the CPU.

Inputs come from numpy seeds; the port runs in fp32, as the JAX package
does. Held to:
* `linear_sample_1d`, periodic and clamp, sample points on integers
  included: values within 1e-6 and the gradients in field and points
  within 1e-5 (floor's gradient is zero in both);
* `burgers_step` at N=32, B=4, periodic and neumann: the state after four
  steps within 1e-5 and its VJP in u and F within 1e-4 relative (a
  gather's scatter-add sums in another order); without force a periodic
  sine keeps its zero mean momentum to 1e-6 over 32 steps;
* `burgers_from_draws` fed `jax.random`'s draws within 1e-6 of the JAX
  package's `random_burgers_states`, and `generate_burgers_dataset` with
  its draws replaced by the JAX package's within 1e-5;
* `CFENet` and `UNet` at dim=1, 'CIRCULAR' and 'SAME', on weights moved
  by `params_from_flax`: outputs within 1e-5 and every parameter's
  gradient at relative norm error 1e-4; flax's CIRCULAR stride-2 taps
  (cells 2i-1, 2i, 2i+1) exactly;
* 1D kernels round-trip through `params_to_flax` exactly, and a Burgers
  `ckpt_*` and `opt_state.msgpack` cross between the packages both ways:
  the networks and the optimizer tree bit for bit, the CFE's outputs
  within 1e-6;
* `ControlTraining(BurgersPDE)` at n=4, B=4, the CFE's output layer
  perturbed so that every net has a gradient: the first iteration's loss
  at rtol 1e-4 and each network's gradient at relative norm error 1e-3,
  for 'chain' and 'staggered' (the tolerances of
  `tests/test_torch_control.py`), and `progress_multi` against as many
  `progress` calls within 1e-6;
* the CLI's `burgers_chain` and `burgers_hierarchical` with `--smoke-test
  --device cpu`: `results.json` with the JAX package's result keys.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from pde_control_tpu.control.pde_burgers import BurgersPDE as JPDE
from pde_control_tpu.control.training import ControlTraining as JApp
from pde_control_tpu.data import generate as jgen
from pde_control_tpu.models import nets as jnets
from pde_control_tpu.ops.interp import linear_sample_1d as jsample
from pde_control_tpu.physics.burgers import BurgersConfig as JConfig
from pde_control_tpu.physics.burgers import burgers_step as jstep
from pde_control_tpu_torch import ControlTraining, params_from_flax
from pde_control_tpu_torch.control.pde_burgers import BurgersPDE
from pde_control_tpu_torch.data import generate
from pde_control_tpu_torch.experiments import run
from pde_control_tpu_torch.experiments.burgers import BURGERS_CFG
from pde_control_tpu_torch.models import nets
from pde_control_tpu_torch.ops.interp import linear_sample_1d
from pde_control_tpu_torch.physics.burgers import BurgersConfig, burgers_step
from pde_control_tpu_torch.utils.checkpoint import _leaves
from pde_control_tpu_torch.utils.convert import params_to_flax

torch.set_num_threads(1)

N, B, STEPS = 32, 4, 4
_CFG = dict(n=N, dx=1.0 / N, dt=0.03, viscosity=0.01)
_CACHE = {}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ------------------------------------------------------------ sampling

@pytest.mark.parametrize("boundary", ["periodic", "clamp"])
def test_linear_sample_1d_matches_jax(boundary):
    rng = np.random.default_rng(0)
    field = rng.normal(size=(B, N)).astype(np.float32)
    x = rng.uniform(-6, N + 6, size=(B, 40)).astype(np.float32)
    x[:, :8] = np.array([-3, -1, 0, 1, 5, N - 1, N, N + 2], np.float32)
    w = rng.normal(size=(B, 40)).astype(np.float32)

    def jloss(f, p):
        return jnp.sum(jsample(f, p, boundary) * w)

    jv = jsample(jnp.asarray(field), jnp.asarray(x), boundary)
    jgf, jgx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(field),
                                               jnp.asarray(x))
    f, p = _t(field).requires_grad_(), _t(x).requires_grad_()
    v = linear_sample_1d(f, p, boundary)
    (v * _t(w)).sum().backward()
    np.testing.assert_allclose(v.detach().numpy(), jv, atol=1e-6)
    np.testing.assert_allclose(f.grad.numpy(), jgf, atol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), jgx, atol=1e-5)


# ------------------------------------------------------------- physics

@pytest.mark.parametrize("boundary", ["periodic", "neumann"])
def test_burgers_step_and_vjp_match_jax(boundary):
    rng = np.random.default_rng(1)
    u0 = rng.normal(size=(B, N)).astype(np.float32)
    force = (0.5 * rng.normal(size=(B, N))).astype(np.float32)
    cot = rng.normal(size=(B, N)).astype(np.float32)
    jcfg, tcfg = (JConfig(**_CFG, boundary=boundary),
                  BurgersConfig(**_CFG, boundary=boundary))

    def jroll(u, f):
        for _ in range(STEPS):
            u = jstep(u, f, jcfg)
        return u

    ju, vjp = jax.vjp(jroll, jnp.asarray(u0), jnp.asarray(force))
    jgu, jgf = vjp(jnp.asarray(cot))
    u, f = _t(u0).requires_grad_(), _t(force).requires_grad_()
    out = u
    for _ in range(STEPS):
        out = burgers_step(out, f, tcfg)
    out.backward(_t(cot))
    np.testing.assert_allclose(out.detach().numpy(), ju, atol=1e-5)
    assert _rel(u.grad.numpy(), jgu) < 1e-4
    assert _rel(f.grad.numpy(), jgf) < 1e-4


def test_burgers_conserves_momentum_without_force():
    """A sine steepening towards a shock keeps its zero mean (the step is
    odd-symmetric about the sine's zeros); a uniform flow keeps its value."""
    amp = torch.tensor([0.25, 0.5, 1.0, 1.5])[:, None]
    x = torch.arange(N, dtype=torch.float32) * (2 * np.pi / N)
    u = amp * torch.sin(x)[None]
    for _ in range(32):
        u = burgers_step(u, None, BURGERS_CFG)
    assert torch.isfinite(u).all()
    assert float(u.mean(dim=1).abs().max()) < 1e-6
    assert float(u.abs().max()) > 0.1  # not diffused away
    c = torch.full((B, N), 0.3)
    assert torch.allclose(burgers_step(c, None, BURGERS_CFG), c, atol=1e-6)


# ----------------------------------------------------------------- data

def _jax_draws(key, batch):
    """The draws of `jgen.random_burgers_states` from `key`, in the
    port's `burgers_draws` layout."""
    k_amp, k_phase = jax.random.split(key)
    return (_t(jax.random.normal(k_amp, (batch, 3))),
            _t(jax.random.uniform(k_phase, (batch, 3), maxval=2 * jnp.pi)))


def test_burgers_from_draws_matches_jax():
    key = jax.random.PRNGKey(7)
    for amplitude in (1.0, 0.5):
        want = jgen.random_burgers_states(key, B, N, amplitude=amplitude)
        got = generate.burgers_from_draws(*_jax_draws(key, B), N,
                                          amplitude=amplitude)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_generate_burgers_dataset_matches_jax(monkeypatch):
    num, batch, seed = 6, 4, 3
    key, draws = jax.random.PRNGKey(seed), []
    for b in (4, 2):
        key, k1, k2 = jax.random.split(key, 3)
        draws += [_jax_draws(k1, b), _jax_draws(k2, b)]
    monkeypatch.setattr(generate, "burgers_draws",
                        lambda gen, b, modes=3: draws.pop(0))
    got = generate.generate_burgers_dataset(BurgersConfig(**_CFG), num, STEPS,
                                            seed=seed, force_amplitude=0.5,
                                            batch=batch, device="cpu")
    want = jgen.generate_burgers_dataset(JConfig(**_CFG), num, STEPS,
                                         seed=seed, force_amplitude=0.5,
                                         batch=batch)
    assert got.obs.shape == (num, STEPS + 1, N, 1) and not got.extras
    np.testing.assert_allclose(got.obs, want.obs, atol=1e-5)


# ----------------------------------------------------------------- nets

_NETS = {"cfe": (lambda pad: jnets.CFENet(out_channels=1, dim=1, padding=pad),
                 lambda pad: nets.CFENet(2, 1, dim=1, padding=pad)),
         "unet": (lambda pad: jnets.UNet(out_channels=1, levels=3,
                                         base_features=4, dim=1, padding=pad),
                  lambda pad: nets.UNet(2, 1, levels=3, base_features=4,
                                        dim=1, padding=pad))}


@pytest.mark.parametrize("net", sorted(_NETS))
@pytest.mark.parametrize("padding", ["CIRCULAR", "SAME"])
def test_nets_at_dim1_match_jax(net, padding):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, N, 2)).astype(np.float32)
    w = rng.normal(size=(B, N, 1)).astype(np.float32)
    jmod = _NETS[net][0](padding)
    params = jax.device_get(jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                               jnp.asarray(x))["params"])
    params = jax.tree_util.tree_map(np.array, params)
    if net == "cfe":  # the zero-initialised output layer
        params["Conv_4"]["kernel"] = (0.1 * rng.normal(
            size=params["Conv_4"]["kernel"].shape)).astype(np.float32)

    def jloss(p):
        y = jmod.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(y * w), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tmod = _NETS[net][1](padding)
    tmod.load_state_dict(params_from_flax({"n": params})["n"])
    y = tmod(_t(x))
    (y * _t(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), jy, atol=1e-5)
    want = params_from_flax({"n": jax.device_get(jg)})["n"]
    for k, p in tmod.named_parameters():
        assert _rel(p.grad.numpy(), want[k].numpy()) < 1e-4, k


def test_circular_stride2_reads_flax_cells():
    x = torch.arange(8, dtype=torch.float32)[None, None]
    for padding, want in (("CIRCULAR", [7, 1, 3, 5]), ("SAME", [0, 2, 4, 6])):
        conv = nets.Conv(1, 1, stride=2, dim=1, padding=padding)
        with torch.no_grad():
            conv.weight.copy_(torch.tensor([[[1.0, 0.0, 0.0]]]))
        assert conv(x)[0, 0].tolist() == want
        jconv = jnets.Conv(1, (3,), strides=(2,), padding=padding,
                           use_bias=False)
        jy = jconv.apply({"params": {"kernel": jnp.array([1.0, 0, 0]).reshape(
            3, 1, 1)}}, jnp.arange(8.0).reshape(1, 8, 1))
        assert np.asarray(jy)[0, :, 0].tolist() == want


def test_1d_kernels_round_trip():
    net = nets.UNet(2, 1, levels=3, base_features=4, dim=1,
                    padding="CIRCULAR")
    sd = net.state_dict()
    tree = params_to_flax({"OP": sd})
    assert tree["OP"]["ConvBlock_0"]["Conv_0"]["kernel"].shape == (3, 2, 4)
    back = params_from_flax(tree)["OP"]
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


# ------------------------------------------------------------- training

def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(B, n + 1, N, 1)).astype(np.float32)}


def _start_params(sequence_class):
    """The JAX package's seeded weights, CFE output layer perturbed."""
    key = ("start", sequence_class)
    if key not in _CACHE:
        japp = JApp(STEPS, JPDE(JConfig(**_CFG)), batch_size=B,
                    sequence_class=sequence_class).prepare()
        params = jax.tree_util.tree_map(np.array, jax.device_get(japp.params))
        k = params["CFE"]["Conv_4"]["kernel"]
        params["CFE"]["Conv_4"]["kernel"] = (0.05 * np.random.default_rng(5)
                                             .normal(size=k.shape)
                                             ).astype(np.float32)
        _CACHE[key] = (japp, params)
    return _CACHE[key]


_TRAIN = {"chain": dict(sequence_class="chain", trainable_networks=("CFE",),
                        obs_loss_frames=(1, 2, 3, 4)),
          "staggered": dict(sequence_class="staggered",
                            trainable_networks=("CFE", "OP4", "OP2"))}


def _first_iteration(name):
    if name not in _CACHE:
        kw = _TRAIN[name]
        japp = JApp(STEPS, JPDE(JConfig(**_CFG)), batch_size=B, force_reg=1e-2,
                    **kw).prepare()
        params = _start_params(kw["sequence_class"])[1]
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            japp._loss_fn, has_aux=True))(params, _batch(STEPS, 0))
        tapp = ControlTraining(STEPS, BurgersPDE(BurgersConfig(**_CFG),
                                                 device="cpu"),
                               batch_size=B, force_reg=1e-2, **kw).prepare()
        tapp.load_params(params_from_flax(params))
        metrics = tapp.compute_gradients(tapp.to_batch(_batch(STEPS, 0)))
        _CACHE[name] = dict(
            jloss=float(jloss), tloss=float(metrics["loss"]),
            jgrads=params_from_flax(jax.device_get(jgrads)),
            tgrads={net: {k: p.grad.clone() for k, p in
                          tapp.nets[net].named_parameters()}
                    for net in kw["trainable_networks"]})
    return _CACHE[name]


@pytest.mark.parametrize("name", sorted(_TRAIN))
def test_first_iteration_loss_matches_jax(name):
    r = _first_iteration(name)
    assert np.isfinite(r["tloss"])
    np.testing.assert_allclose(r["tloss"], r["jloss"], rtol=1e-4)


@pytest.mark.parametrize("name, net", [(c, net) for c, kw in
                                       sorted(_TRAIN.items())
                                       for net in kw["trainable_networks"]])
def test_first_iteration_gradients_match_jax(name, net):
    r = _first_iteration(name)
    tg = torch.cat([g.reshape(-1) for g in r["tgrads"][net].values()])
    jg = torch.cat([r["jgrads"][net][k].reshape(-1) for k in r["tgrads"][net]])
    assert float(jg.norm()) > 0
    assert float((tg - jg).norm() / jg.norm()) < 1e-3


def _tapp(**kw):
    app = ControlTraining(STEPS, BurgersPDE(BurgersConfig(**_CFG),
                                            device="cpu"),
                          batch_size=B, grad_clip=1.0, learning_rate=1e-2,
                          **dict(_TRAIN["staggered"], **kw)).prepare()
    app.load_params(params_from_flax(_start_params("staggered")[1]))
    return app


def test_progress_multi_matches_progress():
    batches = [_batch(STEPS, s) for s in (1, 2, 3)]
    a, b = _tapp(), _tapp()
    got = a.progress_multi({"obs": np.stack([x["obs"] for x in batches])})
    want = [b.progress(x) for x in batches]
    np.testing.assert_allclose(got["loss"].numpy(),
                               [float(m["loss"]) for m in want], rtol=1e-6)
    for (k, p), q in zip(a.nets.named_parameters(), b.nets.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-6, err_msg=k)


def _jax_tree(app) -> dict:
    return flax.serialization.to_state_dict(jax.device_get(app.opt_state))


def _assert_trees_equal(got: dict, want: dict):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w)
    for path in w:
        np.testing.assert_array_equal(np.asarray(g[path]),
                                      np.asarray(w[path]), err_msg=str(path))


def _cfe_outputs(japp, jparams, tapp):
    x = np.random.default_rng(9).normal(size=(B, N, 2)).astype(np.float32)
    jy = japp.cfe.apply({"params": jparams["CFE"]}, jnp.asarray(x))
    with torch.no_grad():
        ty = tapp.nets["CFE"](_t(x))
    return np.asarray(jy), ty.numpy()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer):
    """A Burgers ckpt_* (every net) and autosave (opt_state.msgpack) of
    one package, after two clipped Adam steps, restore in the other."""
    ckpt, auto = str(tmp_path / "ckpt_final"), str(tmp_path / "autosave")
    japp = JApp(STEPS, JPDE(JConfig(**_CFG)), batch_size=B, grad_clip=1.0,
                learning_rate=1e-2, **_TRAIN["staggered"]).prepare()
    japp.params = jax.tree_util.tree_map(jnp.asarray,
                                         _start_params("staggered")[1])
    tapp = _tapp()
    src = japp if writer == "jax" else tapp
    for s in (1, 2):
        src.progress(_batch(STEPS, s))
    src.save(ckpt)
    src.autosave(auto)
    if writer == "jax":
        dst = ControlTraining(STEPS, BurgersPDE(BurgersConfig(**_CFG),
                                                device="cpu"),
                              batch_size=B, grad_clip=1.0, learning_rate=1e-2,
                              restore=ckpt, **_TRAIN["staggered"]).prepare()
        want = params_from_flax(jax.device_get(japp.params))
        for net, sd in dst.state_dicts().items():
            assert all(torch.equal(v, want[net][k]) for k, v in sd.items()), net
        assert dst.try_restore_autosave(auto) == 2
        _assert_trees_equal(dst._opt_state(), _jax_tree(japp))
        jy, ty = _cfe_outputs(japp, japp.params, dst)
    else:
        dst = JApp(STEPS, JPDE(JConfig(**_CFG)), batch_size=B, grad_clip=1.0,
                   learning_rate=1e-2, restore=ckpt,
                   **_TRAIN["staggered"]).prepare()
        got = params_from_flax(jax.device_get(dst.params))
        for net, sd in tapp.state_dicts().items():
            assert all(torch.equal(v, got[net][k]) for k, v in sd.items()), net
        assert dst.try_restore_autosave(auto) == 2
        _assert_trees_equal(tapp._opt_state(), _jax_tree(dst))
        jy, ty = _cfe_outputs(dst, dst.params, tapp)
    assert np.abs(jy).max() > 0
    np.testing.assert_allclose(ty, jy, atol=1e-6)


# ------------------------------------------------------------------- CLI

@pytest.mark.parametrize("name, keys", [
    ("burgers_chain", ("train", "eval")),
    ("burgers_hierarchical", ("cfe_supervised", "op2_supervised",
                              "op4_supervised", "end_to_end_n4",
                              "end_to_end", "eval")),
])
def test_cli_on_the_cpu(tmp_path, name, keys):
    wd = str(tmp_path / name)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        run.main([name, "--smoke-test", "--device", "cpu", "--iterations",
                  "8", "--workdir", wd])
    with open(os.path.join(wd, "results.json")) as f:
        res = json.load(f)
    assert json.loads(out.getvalue()) == res
    for key in keys:
        assert key in res, key
    ev = res["eval"]
    assert ev["eval_samples"] == 16 and len(ev["per_frame_mse"]) == 4
    assert np.isfinite(ev["final_state_mse"]) and ev["zero_force_final_mse"] > 0
    assert ev["mean_abs_force"] > 0
