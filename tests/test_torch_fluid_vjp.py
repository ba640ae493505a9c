"""One step and a four-step rollout of the unfused fluid step, forward and
VJP, from rest and moving, and the one step on the kernel route's plain
version against the Pallas kernel, against the JAX package
(`tests/test_torch_fluid.py`'s inputs and tolerances). In a file of
their own, of at most five tests, because their JAX compiles take most
of that file's time.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.grids import Staggered2D as JStag
from pde_control_tpu.physics import fluid as jfluid
from pde_control_tpu_torch.grids import Domain2D as TDomain
from pde_control_tpu_torch.grids import Staggered2D as TStag
from pde_control_tpu_torch.physics import fluid as tfluid

from test_torch_fluid import (
    H,
    _cfgs,
    _inputs,
    _plate,
    _t,
)


def _rollout(mod, stag, domain, cfg, steps, zeros, vy, vx, rho, fy, fx):
    state = mod.FluidState(velocity=stag(vy, vx), density=rho,
                           pressure=zeros(rho))
    for _ in range(steps):
        state = mod.fluid_step(state, domain, cfg, force=stag(fy, fx))
    return state.velocity.vy, state.velocity.vx, state.density, state.pressure


def _compare(rng, steps, start, backend="auto"):
    m = _plate()
    td = TDomain.create(H, H, obstacle_mask=m, device="cpu")
    jd = JDomain.create(H, H, obstacle_mask=jnp.asarray(m))
    tcfg, jcfg = _cfgs(backend)
    args = _inputs(rng, start)
    weights = [rng.normal(size=s).astype(np.float32)
               for s in ((2, H + 1, H), (2, H, H + 1), (2, H, H))]

    def jloss(*a):
        vy, vx, rho, _ = _rollout(jfluid, JStag, jd, jcfg, steps,
                                  jnp.zeros_like, *a)
        return sum(jnp.sum(w * o) for w, o in zip(weights, (vy, vx, rho))), \
            (vy, vx, rho)

    (_, j_out), j_grads = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(
        *[jnp.asarray(a) for a in args])
    t_args = [_t(a).requires_grad_(True) for a in args]
    t_out = _rollout(tfluid, TStag, td, tcfg, steps, torch.zeros_like, *t_args)
    sum((_t(w) * o).sum() for w, o in zip(weights, t_out)).backward()
    for a, b in zip(t_out, j_out):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())
    for a, b in zip(t_args, j_grads):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("start", ["rest", "moving"])


def test_one_step_forward_and_vjp(rng, start):
    _compare(rng, 1, start)


@pytest.mark.parametrize("start", ["rest", "moving"])


def test_four_step_rollout_forward_and_vjp(rng, start):
    _compare(rng, 4, start)


def test_one_step_kernel_route_against_pallas(rng):
    """backend='cuda' on CPU tensors runs the kernel's plain version; held
    against the JAX package's Pallas kernel (interpret mode)."""
    _compare(rng, 1, "moving", backend="cuda")
