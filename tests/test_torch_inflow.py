"""Inflow and the force mask of `IncompressibleFluidPDE` against the JAX
package's, on the CPU.

16², the smoke task's obstacle course (`default_obstacles`), buoyancy
control with a force mask over the lower half, batch 2, pressure tol
1e-6, inputs from a numpy seed. Held to: the CFE's six input channels
(exact) and the masked force from a net output (exact); one step and a
3-step rollout with inflow, on the unfused route and on the fused route
(`fused='cuda'`, the kernels' plain versions on the CPU), at the fused
step's forward tolerances, atol 5e-6 / rtol 1e-5 (the unfused pressure
differs by up to 1.9e-6 at tol 1e-6). The JAX side is unfused: its tests
pin its fused step to the unfused one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pde_control_tpu.control.pde_fluid import IncompressibleFluidPDE as JPDE
from pde_control_tpu.experiments.fluid2d import default_obstacles
from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.physics.fluid import FluidConfig as JConfig
from pde_control_tpu_torch import Domain2D, FluidConfig, IncompressibleFluidPDE

torch.set_num_threads(1)

H, B = 16, 2
_CFG = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-6, pressure_maxiter=500,
            warm_start_pressure=True)
_TOL = dict(rtol=1e-5, atol=5e-6)


def _mask():
    m = np.zeros((H, H), np.float32)
    m[: H // 2] = 1.0
    return m


def _batch():
    rng = np.random.default_rng(0)
    return {"obs": rng.uniform(0, 1, size=(B, 2, H, H, 1)).astype(np.float32),
            "vy0": (0.3 * rng.normal(size=(B, H + 1, H))).astype(np.float32),
            "vx0": (0.3 * rng.normal(size=(B, H, H + 1))).astype(np.float32),
            "inflow": rng.uniform(0, 0.1, size=(B, H, H)).astype(np.float32)}


def _net_out():
    return np.random.default_rng(1).normal(size=(B, H, H, 1)).astype(np.float32)


_JAX = {}


def _jax():
    """The JAX package's PDE, initial state, inputs, masked force and its
    one-step and 3-step rollouts (cached)."""
    if not _JAX:
        obst = default_obstacles(H, H)
        pde = JPDE(JDomain.create(H, H, obstacle_mask=jnp.asarray(obst)),
                   JConfig(**_CFG), control="buoyancy",
                   force_mask=jnp.asarray(_mask()), with_inflow=True)
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        net = jnp.asarray(_net_out())

        @jax.jit
        def run(batch):
            s0 = pde.initial_state(batch)
            x = pde.cfe_inputs(s0, batch["obs"][:, 1])
            f = pde.force_from_net(net, s0)
            states = [s0]
            for _ in range(3):
                states.append(pde.step(states[-1],
                                       pde.force_from_net(net, states[-1])))
            return x, f, states[1], states[3]

        _JAX.update(zip(("x", "force", "one", "three"),
                        jax.device_get(run(batch))))
        _JAX["example"] = pde.example_state(3)
    return _JAX


def _port(fused="auto"):
    pde = IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=np.array(default_obstacles(H, H)),
                        device="cpu"),
        FluidConfig(**_CFG, fused=fused), control="buoyancy",
        force_mask=_mask(), with_inflow=True, dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    return pde, batch, pde.initial_state(batch)


def test_cfe_inputs_have_the_inflow_channel():
    pde, batch, s0 = _port()
    x = pde.cfe_inputs(s0, batch["obs"][:, 1])
    assert x.shape == (B, H, H, 6)
    np.testing.assert_array_equal(x.numpy(), _jax()["x"])
    assert pde.build_cfe().hidden and \
        pde.build_cfe().get_submodule("Conv_0").weight.shape[1] == 6


def test_masked_force_matches_jax():
    pde, _, s0 = _port()
    f = pde.force_from_net(torch.from_numpy(_net_out()), s0)
    np.testing.assert_array_equal(f.vy.numpy(), _jax()["force"].vy)
    np.testing.assert_array_equal(f.vx.numpy(), _jax()["force"].vx)
    assert float(f.vy[:, H // 2 + 1:].abs().sum()) == 0.0  # masked rows
    assert float(f.vy[:, 1:H // 2].abs().sum()) > 0.0


@pytest.mark.parametrize("fused", ["auto", "cuda"])
def test_steps_with_inflow_match_jax(fused):
    pde, batch, s0 = _port(fused)
    net = torch.from_numpy(_net_out())
    states = [s0]
    for _ in range(3):
        states.append(pde.step(states[-1], pde.force_from_net(net, states[-1])))
    for got, key in ((states[1], "one"), (states[3], "three")):
        want = _jax()[key]
        for name in ("density", "pressure"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       getattr(want, name), **_TOL,
                                       err_msg=f"{key} {name}")
        np.testing.assert_allclose(got.velocity.vy.numpy(), want.velocity.vy,
                                   **_TOL, err_msg=f"{key} vy")
        np.testing.assert_allclose(got.velocity.vx.numpy(), want.velocity.vx,
                                   **_TOL, err_msg=f"{key} vx")
        assert torch.equal(got.inflow, batch["inflow"])
    # The sources add dt·inflow each step.
    assert float(states[3].density.sum()) > float(s0.density.sum())


def test_initial_state_needs_inflow_and_example_carries_it():
    pde, batch, _ = _port()
    del batch["inflow"]
    with pytest.raises(ValueError, match="no 'inflow'"):
        pde.initial_state(batch)
    ex = pde.example_state(3)
    assert ex.inflow.shape == _jax()["example"].inflow.shape == (3, H, H)
    no_inflow = IncompressibleFluidPDE(Domain2D.create(H, H, device="cpu"))
    assert no_inflow.example_state(1).inflow is None
    assert no_inflow.build_cfe().get_submodule("Conv_0").weight.shape[1] == 5
