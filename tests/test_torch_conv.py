"""The 3×3 conv slice against the JAX package's Pallas conv, on the CPU.

* `ops/cuda_conv.py :: conv3x3` (its plain versions run for CPU tensors)
  against `pallas_conv.conv3x3(interpret=True)` at 16², batch 2: in fp32
  the forward at atol 1e-5 and the VJP in x, kernel and bias at 2e-5 of
  each one's scale (as `tests/test_pallas_conv.py` holds the Pallas conv to
  flax); in bf16 all of them within 1e-2 of scale, which holds the rounding
  points (one bf16 ulp is 2⁻⁸).
* `CFENet` and `UNet(levels=2)` with conv_impl='cuda' against the JAX nets
  with conv_impl='pallas' on weights converted by `params_from_flax`, fp32:
  output atol 1e-4, parameter gradients 5e-4 of scale.
* The slice as a whole: the 16², n=4, batch-2 training iteration with
  fused='cuda', conv_impl='cuda' and fp32 nets against the JAX app with
  conv_impl='pallas', the CFE's output layer perturbed so that every net
  gets a gradient: the loss at rtol 1e-4, each net's gradient at relative
  norm error 1e-3 (nonzero), one Adam step at atol 1e-6 (on the
  unperturbed CFE, as `test_torch_training.py` holds it; see there).
* The routing: which convs reach the kernels' wrappers, and what raises.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu.control.pde_fluid import IncompressibleFluidPDE as JPDE
from pde_control_tpu.control.training import ControlTraining as JApp
from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.models import nets as jnets
from pde_control_tpu.ops import pallas_conv
from pde_control_tpu.physics.fluid import FluidConfig as JConfig
from pde_control_tpu_torch import (
    ControlTraining,
    Domain2D,
    FluidConfig,
    IncompressibleFluidPDE,
    params_from_flax,
)
from pde_control_tpu_torch.models import nets as tnets
from pde_control_tpu_torch.ops import cuda_conv

torch.set_num_threads(1)

H, B = 16, 2
_DTYPES = {"fp32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}


# ------------------------------------------------------------------ conv3x3

def _conv_inputs(cin, cout):
    rng = np.random.default_rng(1000 * cin + cout)
    x = rng.normal(size=(B, H, H, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    b = (0.1 * rng.normal(size=cout)).astype(np.float32)
    g = rng.normal(size=(B, H, H, cout)).astype(np.float32)
    return x, k, b, g


@functools.lru_cache(maxsize=None)
def _jax_conv(bias: bool, dtype_name: str):
    """The Pallas conv's output and VJP in x, kernel and bias, jitted."""
    jdtype = _DTYPES[dtype_name][0]

    def f(x, k, b, g):
        y, vjp = jax.vjp(lambda x, k, b: pallas_conv.conv3x3(
            x, k, b if bias else None, dtype=jdtype, interpret=True), x, k, b)
        return (y,) + vjp(g.astype(y.dtype))

    return jax.jit(f)


def _within(got, want, limit):
    """max|got - want| <= limit · max|want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= limit * scale, (err, scale)


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("cin,cout,bias", [(5, 32, True), (64, 64, True),
                                           (32, 1, False), (128, 64, True)])
def test_conv3x3_matches_pallas(cin, cout, bias, dtype_name):
    x, k, b, g = _conv_inputs(cin, cout)
    jy, jgx, jgk, jgb = _jax_conv(bias, dtype_name)(x, k, b, g)
    tdtype = _DTYPES[dtype_name][1]
    xt, kt, bt = (torch.tensor(a, requires_grad=True) for a in (x, k, b))
    y = cuda_conv.conv3x3(xt, kt, bt if bias else None, dtype=tdtype)
    assert y.dtype == tdtype
    y.backward(torch.from_numpy(g).to(tdtype))
    ty = y.detach().float().numpy()
    grads = [(xt.grad, jgx), (kt.grad, jgk)] + ([(bt.grad, jgb)] if bias else [])
    if dtype_name == "fp32":
        np.testing.assert_allclose(ty, np.asarray(jy), rtol=0, atol=1e-5)
        limit = 2e-5
    else:
        _within(ty, jy, 1e-2)
        limit = 1e-2
    for t, j in grads:
        _within(t.numpy(), j, limit)


# --------------------------------------------------------------------- nets

def _random_params(params, rng):
    """Kernels at variance 1/fan_in, biases at 0.1; the CFE's
    zero-initialised output layer included, so every layer is seen."""
    def draw(p):
        std = 0.1 if p.ndim == 1 else 1.0 / np.sqrt(np.prod(p.shape[:-1]))
        return (std * rng.normal(size=p.shape)).astype(np.float32)

    return jax.tree_util.tree_map(draw, params)


def _jax_net(kind, conv_impl):
    if kind == "cfe":
        return jnets.CFENet(out_channels=1, dim=2, dtype=jnp.float32,
                            conv_impl=conv_impl), 5
    return jnets.UNet(out_channels=1, levels=2, dim=2, dtype=jnp.float32,
                      conv_impl=conv_impl), 3


def _torch_net(kind, conv_impl):
    if kind == "cfe":
        return tnets.CFENet(5, 1, conv_impl=conv_impl)
    return tnets.UNet(3, 1, levels=2, conv_impl=conv_impl)


@functools.lru_cache(maxsize=None)
def _jax_net_case(kind):
    """Input, cotangent, random parameters, and the Pallas net's output and
    parameter gradients."""
    rng = np.random.default_rng(7)
    jnet, cin = _jax_net(kind, "xla")  # the same parameter tree, cheaper init
    x = rng.uniform(-1, 1, size=(B, H, H, cin)).astype(np.float32)
    g = rng.normal(size=(B, H, H, 1)).astype(np.float32)
    params = _random_params(
        jax.device_get(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]),
        rng)
    pnet, _ = _jax_net(kind, "pallas")

    def f(p):
        y, vjp = jax.vjp(lambda q: pnet.apply({"params": q}, jnp.asarray(x)), p)
        return y, vjp(jnp.asarray(g))[0]

    y, grads = jax.jit(f)(params)
    return x, g, params, np.asarray(y), params_from_flax(
        {"n": jax.device_get(grads)})["n"]


@pytest.mark.parametrize("kind", ["cfe", "unet"])
def test_net_matches_pallas(kind):
    x, g, params, jy, jgrads = _jax_net_case(kind)
    tnet = _torch_net(kind, "cuda")
    tnet.load_state_dict(params_from_flax({"n": params})["n"])
    y = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=0, atol=1e-4)
    y.backward(torch.from_numpy(g))
    for name, p in tnet.named_parameters():
        _within(p.grad.numpy(), jgrads[name].numpy(), 5e-4)


@pytest.mark.parametrize("kind", ["cfe", "unet"])
def test_names_match_flax_under_every_conv_impl(kind):
    """The parameter names do not depend on conv_impl, so `params_from_flax`
    carries the JAX weights into every route."""
    jnet, cin = _jax_net(kind, "xla")
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, cin)))["params"]
    names = set(params_from_flax({"n": jax.device_get(params)})["n"])
    for conv_impl in tnets.CONV_IMPLS:
        assert set(_torch_net(kind, conv_impl).state_dict()) == names


# ------------------------------------------------------------------ routing

def _count_calls(monkeypatch):
    calls = {"fwd": 0, "dx": 0, "dw": 0}
    for key, name in (("fwd", "conv3x3_forward"), ("dx", "conv3x3_dx"),
                      ("dw", "conv3x3_dw")):
        fn = getattr(cuda_conv, name)

        def counting(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(cuda_conv, name, counting)
    return calls


@pytest.mark.parametrize("stride,size", [(2, 3), (1, 1)])
def test_ineligible_convs_stay_on_conv2d(monkeypatch, stride, size):
    """Under 'cuda' a stride-2 conv and a 1×1 conv never reach the kernels'
    wrappers, and compute what 'xla' computes on the same layout."""
    calls = _count_calls(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    conv = tnets.Conv(4, 6, kernel_size=size, stride=stride, conv_impl="cuda",
                      generator=gen)
    ref = tnets.Conv(4, 6, kernel_size=size, stride=stride)
    ref.load_state_dict(conv.state_dict())
    x = torch.randn(2, 8, 8, 4, generator=gen, requires_grad=True)
    y = conv(x)
    y.sum().backward()
    assert calls == {"fwd": 0, "dx": 0, "dw": 0}
    want = ref(x.detach().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(y.detach(), want.detach(), rtol=0, atol=1e-6)


def test_unet_sends_every_3x3_stride1_conv_to_the_kernels(monkeypatch):
    """UNet(levels=L) has 5L + 2 eligible convs: two per ConvBlock (L + 1 +
    L blocks) and L upsampling convs; the L stride-2 convs and the 1×1
    output conv stay on conv2d. Backward: a dX for each but the first
    (its input is data) and a dW for each."""
    calls = _count_calls(monkeypatch)
    net = tnets.UNet(3, 1, levels=2, base_features=4, conv_impl="cuda")
    net(torch.randn(1, 8, 8, 3)).sum().backward()
    assert calls == {"fwd": 12, "dx": 11, "dw": 12}


@pytest.mark.parametrize("cls,args", [(tnets.Conv, (4, 4)),
                                      (tnets.CFENet, (5, 1)),
                                      (tnets.UNet, (3, 1))])
def test_pallas_and_unported_impls_raise(cls, args):
    with pytest.raises(ValueError, match="'cuda'"):
        cls(*args, conv_impl="pallas")
    for impl in ("patches", "shifted", "im2col"):
        with pytest.raises(ValueError, match="not ported"):
            cls(*args, conv_impl=impl)


# ----------------------------------------------------------- the iteration

N = 4
NETS = ("CFE", "OP4", "OP2")
_CFG = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-6, pressure_maxiter=500,
            warm_start_pressure=True)
_PDE = dict(control="buoyancy", unet_levels=2, cfe_features=(32, 64, 64, 32),
            op_base_features=16)
_APP = dict(trainable_networks=NETS, sequence_class="staggered",
            obs_loss_frames=(N,))


def _plate():
    m = np.zeros((H, H), np.float32)
    m[H // 2, H // 4:H // 2] = 1.0
    return m


def _batch():
    rng = np.random.default_rng(0)
    return {"obs": rng.uniform(0, 1, size=(B, N + 1, H, H, 1)).astype(np.float32),
            "vy0": np.zeros((B, H + 1, H), np.float32),
            "vx0": np.zeros((B, H, H + 1), np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_app():
    """The JAX app with the Pallas conv and its jitted loss-and-gradient.
    Its parameters are initialised through the stock conv (the same tree;
    an eager init through the interpret-mode kernel takes ~30 s), then the
    nets are rebuilt with conv_impl='pallas'."""
    jpde = JPDE(JDomain.create(H, H, obstacle_mask=jnp.asarray(_plate())),
                JConfig(**_CFG), dtype=jnp.float32, conv_impl="xla", **_PDE)
    japp = JApp(N, jpde, batch_size=B, **_APP).prepare()
    jpde.conv_impl = "pallas"
    japp.cfe = jpde.build_cfe()
    japp.ops = {span: jpde.build_op() for span in japp.ops}
    return japp, jax.jit(jax.value_and_grad(japp._loss_fn, has_aux=True))


def _params(perturb_cfe: bool):
    params = jax.tree_util.tree_map(np.array, jax.device_get(_jax_app()[0].params))
    if perturb_cfe:
        # A nonzero CFE output layer, so gradient reaches the OP nets.
        k = params["CFE"]["Conv_4"]["kernel"]
        params["CFE"]["Conv_4"]["kernel"] = (
            0.05 * np.random.default_rng(3).normal(size=k.shape)).astype(np.float32)
    return params


@functools.lru_cache(maxsize=None)
def _iteration(perturb_cfe: bool):
    """Both sides' loss, gradients and parameters after one Adam step, and
    the port's calls of the conv's three directions in that iteration."""
    from pde_control_tpu_torch.ops import cuda_fluid

    japp, value_and_grad = _jax_app()
    params = _params(perturb_cfe)
    (jloss, _), jgrads = value_and_grad(params, _batch())
    updates, _ = japp.optimizer.update(jgrads, japp.optimizer.init(params), params)
    jparams = jax.device_get(jax.tree_util.tree_map(lambda p, u: p + u, params,
                                                    updates))

    tpde = IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=_plate(), device="cpu"),
        FluidConfig(**_CFG, fused="cuda"), dtype=torch.float32,
        conv_impl="cuda", **_PDE)
    tapp = ControlTraining(N, tpde, **_APP).prepare()
    tapp.load_params(params_from_flax(params))
    with pytest.MonkeyPatch.context() as mp:
        calls = _count_calls(mp)
        steps = []
        fwd = cuda_fluid.fused_step_plain_forward
        mp.setattr(cuda_fluid, "fused_step_plain_forward",
                   lambda *a, **k: steps.append(1) or fwd(*a, **k))
        tmetrics = tapp.progress(_batch())
    return dict(
        jloss=float(jloss), jgrads=params_from_flax(jax.device_get(jgrads)),
        jparams=params_from_flax(jparams), tloss=float(tmetrics["loss"]),
        tgrads={n: {k: p.grad.clone() for k, p in tapp.nets[n].named_parameters()}
                for n in NETS},
        tparams={n: tapp.nets[n].state_dict() for n in NETS},
        notfinite=tmetrics["notfinite_total"], calls=calls, steps=len(steps))


def test_iteration_loss_matches_pallas():
    r = _iteration(True)
    assert np.isfinite(r["tloss"])
    np.testing.assert_allclose(r["tloss"], r["jloss"], rtol=1e-4)


@pytest.mark.parametrize("net", NETS)
def test_iteration_gradients_match_pallas(net):
    r = _iteration(True)
    tg = torch.cat([g.reshape(-1) for g in r["tgrads"][net].values()])
    jg = torch.cat([r["jgrads"][net][k].reshape(-1) for k in r["tgrads"][net]])
    assert float(jg.norm()) > 0 and float(tg.norm()) > 0
    assert float((tg - jg).norm() / jg.norm()) < 1e-3


def test_iteration_adam_step_matches_pallas():
    r = _iteration(False)
    assert r["notfinite"] == 0
    for net in NETS:
        for k, v in r["tparams"][net].items():
            np.testing.assert_allclose(v.numpy(), r["jparams"][net][k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=f"{net}.{k}")


def test_iteration_routes_every_eligible_conv():
    """n CFE calls of 5 convs and one call of each OP net (5·2 + 2 eligible
    convs at levels=2) forward; a dW for each; a dX for each but the top
    OP's first conv, whose input is the ground truth. The step runs fused."""
    r = _iteration(True)
    fwd = N * 5 + len(NETS[1:]) * 12
    assert r["calls"] == {"fwd": fwd, "dx": fwd - 1, "dw": fwd}
    assert r["steps"] == N
