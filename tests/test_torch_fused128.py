"""The fused fluid step (K2 forward, K3 backward) at 128², the grid of the
`smoke_128` entries, against the JAX package's, where both K2 and K3 run
in the cluster core's large layout on the card.

* Through the golden that `scripts/make_fused_goldens_128.py` wrote
  (`tests/goldens/fused_step_128.npz`: `pde_control_tpu/ops/pallas_fluid.py
  :: fused_fluid_step(interpret=True)` and its VJP on a closed 128² box
  with the plate, batch 2, tol 1e-7 / maxiter 500; a warm start with force
  and inflow, and zero velocity): on the CPU the plain versions, which the
  wrappers run for CPU tensors, with the tolerances of
  `tests/test_torch_goldens.py` (vy4, vx4 and rho1 at atol 5e-6 / rtol
  1e-5, the VJP at 3e-5 of each cotangent's largest entry), but the
  pressure at 5e-6 of its largest entry, the limit of the solve's goldens
  (`tests/test_torch_pcg128.py`): at 128² the two fp32 CG loops, stopped
  at tol 1e-7 with their sums in another order, leave the pressure 8.7e-6
  apart at a cell of |p| ~ 0.1 (2.0e-6 of max|p| = 4.29), above atol 5e-6
  + rtol 1e-5·|p| there. Trip counts within 3 of the JAX package's CG on
  the same systems (the limit `chip_smoke.py` holds the kernels to
  against the plain versions). On a machine with a GPU

      python -m pytest tests/test_torch_fused128.py --noconftest -q

  also holds the kernels to the golden under their plan and every plan
  their launchers take: outputs within 1e-4 and cotangents within 1e-3 of
  the golden's largest entry, trips within 3.
* The slice on the CPU: the port's app at the settings of
  `profile_bench.make_app(128, 2, 1, "cpu", maxiter=200, fused="cuda")` (its
  fused step on the plain versions) against the JAX package's app of
  `__graft_entry__._make_app(128, 2, 1, maxiter=200, fused="pallas")` on the
  same weights (converted by `params_from_flax`, the CFE's output layer
  perturbed so that OP2 gets a gradient) and batch: the first iteration's
  loss at rtol 1e-4 and each net's gradient at relative norm error 1e-3, the
  fused tolerances of `tests/test_torch_training.py`. Both apps are built
  with fp32 nets, otherwise at those settings: with the apps' bf16 nets the
  two packages' gradients differ by 7–9% of their norm (the loss by 9.3e-5)
  though the physics agrees to 1e-7, since bf16 rounds the nets' small
  differences up to its own step; with fp32 nets they agree to 1.6e-6 (CFE)
  and 1.1e-5 (OP2).
  These tests are in `tests/test_torch_fused128_slice.py` (a file of at
  most five tests, which the test run hands out last).
* The route: `FluidConfig(fused='cuda')` takes a 136² domain and refuses
  a 237² one, naming the gate.

The golden tests import neither JAX nor the JAX package; the slice's
tests import them inside and skip where the JAX package cannot be
imported (the card).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pde_control_tpu_torch.ops import cuda_cg, cuda_fluid

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "goldens" / "fused_step_128.npz"
CASES = ("warm-force-inflow", "zero-velocity")
OUTS = ("vy4", "vx4", "rho1", "p")
GRADS = ("vy", "vx", "rho", "fy", "fx", "inflow")
H, N, B = 128, 2, 1
NETS = ("CFE", "OP2")
# The settings of both packages' `_make_app(128, 2, 1, maxiter=200)`.
_CFG = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-4, pressure_maxiter=200,
            warm_start_pressure=True)
_PDE = dict(control="buoyancy", unet_levels=3, cfe_features=(32, 64, 64, 32),
            op_base_features=16)
_APP = dict(batch_size=B, trainable_networks=NETS, sequence_class="staggered",
            obs_loss_frames=(N,))


def _case(case: str, dev):
    """The golden's step operands, output cotangents, settings, outputs,
    input cotangents (None where the case has no such operand) and trip
    counts."""
    z = np.load(GOLDEN)

    def t(key):
        return torch.tensor(z[key].astype(np.float32), device=dev)

    zero_v = case == "zero-velocity"
    cfg = json.loads(str(z["config"]))
    trips = cfg.pop("trips")[case]
    state = tuple(torch.zeros_like(t(k)) if zero_v else t(k) for k in ("vy", "vx")
                  ) + (t("rho"),)
    ops = dict(fy=t("fy"), fx=t("fx"), inflow=None if zero_v else t("inflow"),
               x0=None if zero_v else t("x0"))
    geom = tuple(t(k) for k in ("acc_y", "acc_x", "fluid"))
    cots = [t(k) for k in ("g_vy4", "g_vx4", "g_rho1", "g_p")]
    outs = [z[f"{case}/{n}"] for n in OUTS]
    grads = [None if zero_v and n == "inflow" else z[f"{case}/d_{n}"]
             for n in GRADS]
    return state, ops, geom, cots, cfg, outs, grads, trips


def _within_scale(got, want, limit, label):
    got = got.detach().cpu().numpy()
    scale = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=limit,
                               err_msg=label)


def _trips_within(got, want, label):
    assert int(np.abs(got.cpu().numpy() - np.asarray(want)).max()) <= 3, label


def test_golden_is_small_and_whole():
    """At most 3 MB; the plate in a closed 128² box; float16-exact inputs
    and output cotangents; finite float32 outputs and cotangents of every
    case; settings and trip counts in `config`, every solve stopped by the
    tolerance, not by maxiter."""
    assert GOLDEN.stat().st_size <= 3 * 2 ** 20
    z = np.load(GOLDEN)
    fluid = z["fluid"]
    assert fluid.shape == (H, H) and fluid[64, 32:64].sum() == 0
    assert fluid.sum() == H * H - 32
    assert z["acc_y"][0].sum() == 0 and z["acc_x"][:, 0].sum() == 0  # walls
    shapes = dict(vy=(2, H + 1, H), vx=(2, H, H + 1), rho=(2, H, H))
    for k in ("vy", "vx", "rho", "fy", "fx", "inflow", "x0", "g_vy4", "g_vx4",
              "g_rho1", "g_p"):
        assert z[k].dtype == np.float16, k
    for k, shape in shapes.items():
        assert z[k].shape == shape
    cfg = json.loads(str(z["config"]))
    assert cfg["max_shift"] == 2 and cfg["tol"] == 1e-7
    for case in CASES:
        for n in OUTS + tuple(f"d_{g}" for g in GRADS):
            if case == "zero-velocity" and n == "d_inflow":
                assert f"{case}/{n}" not in z
                continue
            a = z[f"{case}/{n}"]
            assert a.dtype == np.float32 and np.isfinite(a).all(), (case, n)
        for where in ("fwd", "bwd"):
            trips = cfg["trips"][case][where]
            assert len(trips) == 2 and 0 < min(trips) <= max(trips) < cfg["maxiter"]


@pytest.mark.parametrize("case", CASES)
def test_plain_fused_step_matches_golden(case):
    """The plain K2 and K3 on CPU tensors (no launch) against the JAX
    package's step and VJP at 128²."""
    state, ops, geom, cots, cfg, outs, grads, trips = _case(case, "cpu")
    before = (cuda_fluid.LAUNCHES_FWD, cuda_fluid.LAUNCHES_BWD)
    out = cuda_fluid.fused_step_forward(*state, *geom, **ops, **cfg)
    for name, got, want in zip(OUTS[:3], out, outs):
        np.testing.assert_allclose(got.numpy(), want, atol=5e-6, rtol=1e-5,
                                   err_msg=name)
    _within_scale(out[3], outs[3], 5e-6, "p")
    _trips_within(out[4], trips["fwd"], "forward trips")
    got = cuda_fluid.fused_step_backward(*state, *cots, *geom, has_force=True,
                                         has_inflow=ops["inflow"] is not None,
                                         **cfg)
    for name, a, want in zip(GRADS, got, grads):
        assert (a is None) == (want is None), name
        if a is not None:
            _within_scale(a, want, 3e-5, name)
    _trips_within(got[6], trips["bwd"], "backward trips")
    assert (cuda_fluid.LAUNCHES_FWD, cuda_fluid.LAUNCHES_BWD) == before


@pytest.mark.parametrize("case", CASES)
@pytest.mark.requires_cuda
def test_kernels_match_golden(case):
    """K2 and K3 on the card, each in the large layout under its plan and
    every plan its launcher takes at 128² (C = 8 and 16), against the JAX
    package's step and VJP; each launch counts once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    state, ops, geom, cots, cfg, outs, grads, trips = _case(case, dev)
    assert cuda_fluid.fwd_layout(H, H) == cuda_cg.LARGE
    assert cuda_fluid.bwd_layout(H, H, cfg["max_shift"]) == cuda_cg.LARGE
    plans = cuda_fluid.fwd_plans(H, H)
    assert [p.cluster for p in plans] == [8, 16]
    step_ops = [ops[k] for k in ("fy", "fx", "inflow", "x0")]
    for plan in [None] + plans:
        before = cuda_fluid.LAUNCHES_FWD
        out = cuda_fluid._launch_forward(*state, *geom, *step_ops, plan, **cfg)
        torch.cuda.synchronize()
        assert cuda_fluid.LAUNCHES_FWD == before + 1
        for name, got, want in zip(OUTS, out, outs):
            _within_scale(got, want, 1e-4, f"{name} {plan}")
        _trips_within(out[4], trips["fwd"], f"forward trips {plan}")
    plans = cuda_fluid.bwd_plans(H, H)
    assert [p.cluster for p in plans] == [8, 16]
    for plan in [None] + plans:
        before = cuda_fluid.LAUNCHES_BWD
        got = cuda_fluid._launch_backward(
            *state, *cots, *geom, plan, has_force=True,
            has_inflow=ops["inflow"] is not None, **cfg)
        torch.cuda.synchronize()
        assert cuda_fluid.LAUNCHES_BWD == before + 1
        for name, a, want in zip(GRADS, got, grads):
            assert (a is None) == (want is None), name
            if a is not None:
                _within_scale(a, want, 1e-3, f"{name} {plan}")
        _trips_within(got[6], trips["bwd"], f"backward trips {plan}")


def _plate(n: int) -> np.ndarray:
    m = np.zeros((n, n), np.float32)
    m[n // 2, n // 4:n // 2] = 1.0
    return m


@pytest.mark.parametrize("n,fits", [(136, True), (237, False)])
def test_fused_route_takes_128_and_refuses_136(n, fits):
    """`FluidConfig(fused='cuda')` on a CPU domain with the plate: beyond
    the old edge of 128, at 136², one step runs on the plain K2 (no
    launch); at 237², outside the JAX package's fused gate, the step
    raises, naming the gate and its edge."""
    from pde_control_tpu_torch.grids import Domain2D
    from pde_control_tpu_torch.physics import fluid

    domain = Domain2D.create(n, n, obstacle_mask=_plate(n), device="cpu")
    cfg = fluid.FluidConfig(fused="cuda", dt=1.0, buoyancy=0.08,
                            pressure_tol=1e-4, pressure_maxiter=200)
    state = fluid.FluidState.zeros(1, n, n, device="cpu")
    state.density[0, 8:16, 40:56] = 1.0
    assert cuda_fluid.fused_step_fits(n, n) is fits
    if not fits:
        with pytest.raises(ValueError, match="fused_step_fits takes: the JAX "
                           "package's fused gate, squares up to 236²"):
            fluid.fluid_step(state, domain, cfg)
        return
    before = (cuda_fluid.LAUNCHES_FWD, cuda_fluid.LAUNCHES_BWD)
    out = fluid.fluid_step(state, domain, cfg)
    assert (cuda_fluid.LAUNCHES_FWD, cuda_fluid.LAUNCHES_BWD) == before
    assert torch.isfinite(out.velocity.vy).all()
    assert float(out.velocity.vy.abs().max()) > 0  # buoyancy moved the fluid
