"""The port's CFE and OP networks against the JAX package's, on weights
converted by `params_from_flax`.

Weights are drawn from a numpy seed (the CFE's zero-initialised output layer
included, so the comparison sees every layer). fp32 agrees at atol 1e-5;
bf16 rounds at other places in the two frameworks, so it is held at rtol
2e-2 (atol 2e-2 of the output's scale).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu.models import nets as jnets
from pde_control_tpu_torch.models import nets as tnets
from pde_control_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

H = 16


def _random_params(params, rng):
    """Kernels at variance 1/fan_in (outputs of order one), biases at 0.1."""
    def draw(p):
        std = 0.1 if p.ndim == 1 else 1.0 / np.sqrt(np.prod(p.shape[:-1]))
        return (std * rng.normal(size=p.shape)).astype(np.float32)

    return jax.tree_util.tree_map(draw, params)


def _pair(kind, dtype_name, rng):
    jdtype = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    tdtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    if kind == "cfe":
        cin, cout = 5, 1
        jnet = jnets.CFENet(out_channels=cout, dim=2, dtype=jdtype)
        tnet = tnets.CFENet(cin, cout, dtype=tdtype)
    else:
        cin, cout = 3, 1
        jnet = jnets.UNet(out_channels=cout, levels=2, base_features=8, dim=2,
                          dtype=jdtype)
        tnet = tnets.UNet(cin, cout, levels=2, base_features=8, dtype=tdtype)
    x = rng.uniform(-1, 1, size=(2, H, H, cin)).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _random_params(jax.device_get(params), rng)
    tnet.load_state_dict(params_from_flax({"net": params})["net"])
    return jnet, params, tnet, x


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["cfe", "unet"])
def test_net_matches_flax(rng, kind, dtype_name):
    jnet, params, tnet, x = _pair(kind, dtype_name, rng)
    j = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    t = tnet(torch.from_numpy(x)).detach().numpy()
    assert t.shape == j.shape and t.dtype == np.float32
    if dtype_name == "fp32":
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(t, j, rtol=2e-2, atol=2e-2 * np.abs(j).max())


@pytest.mark.parametrize("kind", ["cfe", "unet"])
def test_net_input_gradient_matches_flax(rng, kind):
    jnet, params, tnet, x = _pair(kind, "fp32", rng)
    g = rng.normal(size=x.shape[:-1] + (1,)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jnet.apply({"params": params}, a), jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    tnet(xt).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-5 * max(1.0, np.abs(np.asarray(gj)).max()))


@pytest.mark.parametrize("size", [8, 7])
def test_stride2_same_padding(rng, size):
    """flax's SAME at stride 2 pads (0, 1) on an even input — not (1, 1)."""
    x = rng.normal(size=(1, size, size, 2)).astype(np.float32)
    jconv = jnets.Conv(3, (3, 3), strides=(2, 2), padding="SAME")
    params = jconv.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    j = np.asarray(jconv.apply({"params": params}, jnp.asarray(x)))
    tconv = tnets.Conv(2, 3, stride=2)
    tconv.load_state_dict(params_from_flax({"c": jax.device_get(params)})["c"])
    t = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0, atol=1e-5)
    assert tnets._same_pads(8, 3, 2) == (0, 1)
    assert tnets._same_pads(7, 3, 2) == (1, 1)


def test_names_match_flax(rng):
    """Every flax parameter has a torch counterpart of the converted name."""
    for kind in ("cfe", "unet"):
        _, params, tnet, _ = _pair(kind, "fp32", rng)
        assert set(params_from_flax({"n": params})["n"]) == set(tnet.state_dict())


def test_cfe_output_starts_at_zero(rng):
    tnet = tnets.CFENet(5, 1, generator=torch.Generator().manual_seed(0))
    out = tnet(torch.from_numpy(rng.normal(size=(2, H, H, 5)).astype(np.float32)))
    assert float(out.detach().abs().max()) == 0.0
