"""The indirect-smoke task at 256² (`fluid2d.run_smoke_indirect(size=256)`'s
grid, where the pressure solve (K1) runs its banded layout on the card)
against the JAX package's, on the CPU.

* The slice: the port's first training iteration of the task's app
  (`default_obstacles(256, 256)`, an inflow plume, buoyancy control, CFE
  48-96-96-48, OP2 with 3 levels at base width 16, tol 1e-4 / maxiter 200,
  warm start), its pressure solve on 'cuda', which for CPU tensors runs
  K1's plain version (`cuda_cg.pcg_plain`, 2n - 1 solves an iteration),
  against the JAX package's app with `FluidConfig(pressure_backend=
  'pallas')`, its Pallas CG in interpret mode, on the same weights
  (converted by `params_from_flax`, the CFE's output layer perturbed so
  that OP2 gets a gradient) and batch. Cut: n = 2 and batch 1 (the task's
  16 and 8), so that OP2 is the only OP net, and both packages' nets in
  fp32 (the apps' bf16 rounds the nets' small differences up to its step,
  as `tests/test_torch_fused128.py` says). The loss at rtol 1e-4 and each
  net's gradient at relative norm error 1e-3, the limits of
  `tests/test_torch_fused128.py`.
* The routes at 256² with the plate: 'auto' picks the kernel for a field
  on the card and 'cuda' takes the grid, while `FluidConfig(fused='cuda')`
  refuses it (K2/K3 stop at 128²).

The JAX side is computed once per module; it skips where the JAX package
cannot be imported (the card).
"""

import functools

import numpy as np
import pytest
import torch

from pde_control_tpu_torch.ops import cuda_cg

torch.set_num_threads(1)

H, N, B = 256, 2, 1
NETS = ("CFE", "OP2")
# `fluid2d._smoke_indirect_setup`'s physics and nets.
_CFG = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-4, pressure_maxiter=200,
            warm_start_pressure=True)
_PDE = dict(control="buoyancy", with_inflow=True, unet_levels=3,
            cfe_features=(48, 96, 96, 48), op_base_features=16)
_APP = dict(batch_size=B, trainable_networks=NETS, sequence_class="staggered",
            obs_loss_frames=(N,))


def _obstacles() -> np.ndarray:
    from pde_control_tpu_torch.experiments.fluid2d import default_obstacles

    return np.asarray(default_obstacles(H, H), np.float32)


def _batch() -> dict:
    """Targets, a small start velocity and an inflow source near the
    bottom, from a numpy seed."""
    rng = np.random.default_rng(256)
    inflow = np.zeros((B, H, H), np.float32)
    inflow[:, 8:24, 96:160] = rng.uniform(0.0, 0.05, size=(B, 16, 64))
    return {"obs": rng.uniform(0, 1, size=(B, N + 1, H, H, 1)).astype(np.float32),
            "vy0": (0.05 * rng.normal(size=(B, H + 1, H))).astype(np.float32),
            "vx0": (0.05 * rng.normal(size=(B, H, H + 1))).astype(np.float32),
            "inflow": inflow}


def _perturbed(params):
    """A nonzero CFE output layer (0.05·N(0, 1) from a numpy seed), so that
    a gradient reaches OP2."""
    k = params["CFE"]["Conv_4"]["kernel"]
    params["CFE"]["Conv_4"]["kernel"] = (
        0.05 * np.random.default_rng(3).normal(size=k.shape)).astype(np.float32)
    return params


@functools.lru_cache(maxsize=1)
def _jax_iteration():
    """The JAX package's first iteration, the solve on 'pallas' (interpret
    mode on the CPU), fp32 nets: its loss, its gradients (converted to the
    port's names) and its weights."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    pytest.importorskip("pde_control_tpu.control.training")
    from pde_control_tpu.control.pde_fluid import IncompressibleFluidPDE
    from pde_control_tpu.control.training import ControlTraining
    from pde_control_tpu.grids import Domain2D
    from pde_control_tpu.physics.fluid import FluidConfig
    from pde_control_tpu_torch import params_from_flax

    pde = IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=jnp.asarray(_obstacles())),
        FluidConfig(**_CFG, pressure_backend="pallas"), dtype=jnp.float32,
        **_PDE)
    app = ControlTraining(N, pde, **_APP).prepare()
    params = _perturbed(jax.tree_util.tree_map(np.array,
                                               jax.device_get(app.params)))
    (loss, _), grads = jax.jit(jax.value_and_grad(app._loss_fn, has_aux=True))(
        params, _batch())
    return (float(loss), params_from_flax(jax.device_get(grads)),
            params_from_flax(params))


@functools.lru_cache(maxsize=1)
def _port_iteration():
    """The port's first iteration, the solve on 'cuda' (K1's plain version
    on the CPU), on the JAX app's weights: its loss, its gradients and the
    plain solves' count."""
    from pde_control_tpu_torch import (
        ControlTraining,
        Domain2D,
        FluidConfig,
        IncompressibleFluidPDE,
    )

    _, _, params = _jax_iteration()
    pde = IncompressibleFluidPDE(
        Domain2D.create(H, H, obstacle_mask=_obstacles(), device="cpu"),
        FluidConfig(**_CFG, pressure_backend="cuda"), dtype=torch.float32,
        **_PDE)
    app = ControlTraining(N, pde, **_APP).prepare()
    app.load_params(params)
    calls = []
    plain = cuda_cg.pcg_plain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_cg, "pcg_plain",
                   lambda *a, **k: calls.append(a[0].shape) or plain(*a, **k))
        metrics = app.compute_gradients(app.to_batch(_batch()))
    grads = {name: {k: p.grad.clone() for k, p in net.named_parameters()}
             for name, net in app.nets.items()}
    return float(metrics["loss"]), grads, calls


def test_slice_loss_matches_jax():
    """The 256² first iteration with every pressure solve on K1's plain
    version (2n - 1 of them at 256²) against the JAX package's Pallas CG."""
    jloss, _, _ = _jax_iteration()
    tloss, _, calls = _port_iteration()
    assert calls == [(B, H, H)] * (2 * N - 1)
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


def test_routes_at_256():
    """'auto' on the card takes K1 at 256² with the task's obstacles, as the
    JAX package takes its Pallas CG there on a TPU, and 'cuda' takes the
    grid (plain on the CPU); `fused='cuda'` refuses it, naming the gate."""
    from pde_control_tpu_torch.grids import Domain2D
    from pde_control_tpu_torch.physics import fluid, poisson

    domain = Domain2D.create(H, H, obstacle_mask=_obstacles(), device="cpu")
    div = torch.zeros(1, H, H)
    assert poisson._pick_backend("auto", div, domain, on_cuda=True) == "cuda"
    assert poisson._pick_backend("auto", div, domain) == "pcg"
    assert poisson._pick_backend("cuda", div, domain) == "cuda"
    cfg = fluid.FluidConfig(fused="cuda", **_CFG)
    state = fluid.FluidState.zeros(1, H, H, device="cpu")
    with pytest.raises(ValueError, match="fused_step_fits takes: the JAX "
                       "package's fused gate, squares up to 236²"):
        fluid.fluid_step(state, domain, cfg)
