"""The 128² training iteration on the fused route's plain versions against
the JAX package's Pallas fused step: the loss and each net's gradient
(`tests/test_torch_fused128.py`'s slice and tolerances). In a file of
their own, of at most five tests, because their JAX compile is the
slowest part of that file. Like those tests, they import JAX inside and
skip where the JAX package cannot be imported (the card).
"""

import functools

import numpy as np
import pytest
import torch

from pde_control_tpu_torch.ops import cuda_fluid

from test_torch_fused128 import (
    B,
    H,
    N,
    NETS,
    _APP,
    _CFG,
    _PDE,
    _plate,
)


def _batch():
    """`__graft_entry__._make_batch(128, 2, 1)`."""
    from pde_control_tpu_torch.experiments import profile_bench

    return profile_bench.make_batch(H, N, B)


def _perturbed(params):
    """A nonzero CFE output layer (0.05·N(0, 1) from a numpy seed, as
    `tests/test_torch_training.py` and `chip_smoke.perturb_cfe` load), so
    that a gradient reaches OP2."""
    k = params["CFE"]["Conv_4"]["kernel"]
    params["CFE"]["Conv_4"]["kernel"] = (
        0.05 * np.random.default_rng(3).normal(size=k.shape)).astype(np.float32)
    return params


@functools.lru_cache(maxsize=1)


def _jax_iteration():
    """The JAX package's first iteration at the settings of `_make_app(128,
    2, 1, maxiter=200, fused='pallas')` with fp32 nets: its loss, its
    gradients (converted to the port's names) and its weights. Called once
    per module; skips where the JAX package cannot be imported."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    pytest.importorskip("pde_control_tpu.control.training")
    from pde_control_tpu.control.pde_fluid import IncompressibleFluidPDE
    from pde_control_tpu.control.training import ControlTraining
    from pde_control_tpu.grids import Domain2D
    from pde_control_tpu.physics.fluid import FluidConfig
    from pde_control_tpu_torch import params_from_flax

    # `__graft_entry__._make_app`'s app, its nets in fp32.
    pde = IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=jnp.asarray(_plate(H))),
        FluidConfig(**_CFG, fused="pallas"), dtype=jnp.float32, **_PDE)
    app = ControlTraining(N, pde, **_APP).prepare()
    params = _perturbed(jax.tree_util.tree_map(np.array,
                                               jax.device_get(app.params)))
    (loss, _), grads = jax.jit(jax.value_and_grad(app._loss_fn, has_aux=True))(
        params, _batch())
    return (float(loss), params_from_flax(jax.device_get(grads)),
            params_from_flax(params))


@functools.lru_cache(maxsize=1)


def _port_iteration():
    """The port's first iteration, fused on the plain versions, on the JAX
    app's weights: its loss and gradients, and the K2/K3 wrappers' calls."""
    from pde_control_tpu_torch import (
        ControlTraining,
        Domain2D,
        FluidConfig,
        IncompressibleFluidPDE,
    )

    _, _, params = _jax_iteration()
    # `profile_bench.make_app(128, 2, 1, "cpu", maxiter=200, fused="cuda")`,
    # its nets in fp32.
    pde = IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=_plate(H), device="cpu"),
        FluidConfig(**_CFG, fused="cuda"), dtype=torch.float32, **_PDE)
    app = ControlTraining(N, pde, **_APP).prepare()
    app.load_params(params)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("fused_step_plain_forward", "fused_step_plain_backward"):
            fn = getattr(cuda_fluid, name)
            mp.setattr(cuda_fluid, name, lambda *a, _fn=fn, _n=name, **k:
                       calls.append(_n) or _fn(*a, **k))
        metrics = app.compute_gradients(app.to_batch(_batch()))
    grads = {name: {k: p.grad.clone() for k, p in net.named_parameters()}
             for name, net in app.nets.items()}
    return float(metrics["loss"]), grads, calls


def test_slice_loss_matches_jax():
    """The 128² first iteration under fused='cuda' (one K2 and one K3 a
    step, plain on the CPU) against the JAX package's fused='pallas'."""
    jloss, _, _ = _jax_iteration()
    tloss, _, calls = _port_iteration()
    assert calls.count("fused_step_plain_forward") == N
    assert calls.count("fused_step_plain_backward") == N
    assert np.isfinite(tloss)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)


@pytest.mark.parametrize("net", NETS)


def test_slice_gradients_match_jax(net):
    _, jgrads, _ = _jax_iteration()
    _, tgrads, _ = _port_iteration()
    tg = torch.cat([g.reshape(-1) for g in tgrads[net].values()])
    jg = torch.cat([jgrads[net][k].reshape(-1) for k in tgrads[net]])
    assert float(jg.norm()) > 0 and float(tg.norm()) > 0
    assert float((tg - jg).norm() / jg.norm()) < 1e-3
