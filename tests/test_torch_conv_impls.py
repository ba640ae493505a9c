"""The nets' matmul reformulations of the 3×3 stride-1 SAME conv
(`conv_impl` 'patches', 'shifted', 'im2col') against the JAX package's
same impls, on the CPU.

`CFENet` (8-16 wide) and `UNet(levels=2, base 4)` in fp32 at 16², batch 2,
on weights drawn from a numpy seed and converted by `params_from_flax`
(the CFE's zero-initialised output layer drawn too): the output and every
parameter's gradient of a random cotangent at atol 1e-5 of its scale. The
layers that are not 3×3 stride 1 (the U-net's stride-2 and 1×1 convs) take
the standard conv under every impl, as in the JAX package: each impl's
output equals 'xla''s at the same tolerance.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu.models import nets as jnets
from pde_control_tpu_torch.models import nets as tnets
from pde_control_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

H, B = 16, 2
IMPLS = ("patches", "shifted", "im2col")


def _nets(kind, impl):
    if kind == "cfe":
        cin = 5
        jnet = jnets.CFENet(out_channels=1, features=(8, 16), dim=2,
                            conv_impl=impl)
        tnet = tnets.CFENet(cin, 1, features=(8, 16), conv_impl=impl)
    else:
        cin = 3
        jnet = jnets.UNet(out_channels=1, levels=2, base_features=4, dim=2,
                          conv_impl=impl)
        tnet = tnets.UNet(cin, 1, levels=2, base_features=4, conv_impl=impl)
    return jnet, tnet, cin


@functools.lru_cache(maxsize=None)
def _case(kind):
    """Inputs, flax params and a cotangent, drawn once per net."""
    rng = np.random.default_rng(7 if kind == "cfe" else 8)
    jnet, _, cin = _nets(kind, "xla")
    x = rng.uniform(-1, 1, size=(B, H, H, cin)).astype(np.float32)
    params = jax.device_get(jnet.init(jax.random.PRNGKey(0),
                                      jnp.asarray(x))["params"])

    def draw(p):
        std = 0.1 if p.ndim == 1 else 1.0 / np.sqrt(np.prod(p.shape[:-1]))
        return (std * rng.normal(size=p.shape)).astype(np.float32)

    params = jax.tree_util.tree_map(draw, params)
    g = rng.normal(size=(B, H, H, 1)).astype(np.float32)
    return x, params, g


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kind", ["cfe", "unet"])
def test_conv_impl_matches_jax(kind, impl):
    x, params, g = _case(kind)
    jnet, tnet, _ = _nets(kind, impl)
    out, vjp = jax.vjp(lambda p: jnet.apply({"params": p}, jnp.asarray(x)),
                       params)
    (jgrads,) = vjp(jnp.asarray(g))
    tnet.load_state_dict(params_from_flax({"n": params})["n"])
    y = tnet(torch.from_numpy(x))
    y.backward(torch.from_numpy(g))
    _close(y.detach().numpy(), np.asarray(out), "output")
    want = params_from_flax({"n": jax.device_get(jgrads)})["n"]
    got = dict(tnet.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        _close(got[name].grad.numpy(), w.numpy(), name)


@pytest.mark.parametrize("impl", IMPLS)
def test_conv_impl_routes_only_3x3_stride1(impl, monkeypatch):
    """Each impl's function sees exactly the 3×3 stride-1 SAME convs (two per
    ConvBlock, L + 1 + L blocks, and L upsampling convs: 5L + 2), and the
    net agrees with the standard conv."""
    x, params, _ = _case("unet")
    calls = []
    fn = tnets._MATMUL_IMPLS[impl]
    monkeypatch.setitem(tnets._MATMUL_IMPLS, impl,
                        lambda x, w, b: calls.append(w.shape) or fn(x, w, b))
    sd = params_from_flax({"n": params})["n"]
    nets = {}
    for name in ("xla", impl):
        nets[name] = tnets.UNet(3, 1, levels=2, base_features=4, conv_impl=name)
        nets[name].load_state_dict(sd)
    with torch.no_grad():
        got = nets[impl](torch.from_numpy(x)).numpy()
        want = nets["xla"](torch.from_numpy(x)).numpy()
    assert len(calls) == 5 * 2 + 2
    assert all(s[2:] == (3, 3) for s in calls)
    _close(got, want, impl)
