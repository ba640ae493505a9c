"""The fused fluid step (K2 forward, K3 backward) beyond 128², where both
run the cluster core's banded layout on the card (K3's window phase in
global memory), against the JAX package's, up to the Pallas fluid gate's
edge.

* Through the golden that `scripts/make_fused_goldens_big.py` wrote
  (`tests/goldens/fused_step_big.npz`: `pde_control_tpu/ops/pallas_fluid.py
  :: fused_fluid_step(interpret=True)` and its VJP on closed boxes with the
  plate at 236², the gate's square edge, and 64×625, its edge at 64 rows,
  batch 1, tol 1e-7 / maxiter 500; a warm start with force and inflow, and
  zero velocity): on the CPU the plain versions, which the wrappers run
  for CPU tensors, rho1 at `tests/test_torch_fused128.py`'s atol 5e-6 /
  rtol 1e-5 and the rest at `LIMITS`, wider than that file's beyond 128²,
  where the two fp32 CG loops, stopped at tol 1e-7, differ more: at 236²
  p by 3.1e-6 of its largest entry, which the pressure gradient carries
  into vy4 and vx4 (7.6e-6 at a face, 1.4e-6 of max|p|, 4e-5 of their own
  largest entry at zero velocity), the VJP by up to 2.5e-5; at 64×625,
  where the transpose solve needs ~210 trips with its residual near fp32's
  floor, the trips by up to 13, p by 1.4e-5 and the VJP by up to 2.1e-4.
  Both loops round in fp32, and each is as far from the same step in
  float64 as from the other (`scripts/fused_big_precision.py`, 8 CPU
  threads): at 64×625 the worst cotangent, dfy, is 2.35e-4 of its largest
  entry from the golden, 1.50e-4 from the port's float64 step, and the
  golden 1.57e-4 from it; p 1.22e-5, 1.10e-5 and 4.6e-6; the float64
  solves need 135-137 trips against 192-220 in fp32. The golden was
  written on the CPU, whose dots compute in fp32 whatever their precision
  says; rounding the preconditioner products' inputs to bf16, as the
  Pallas kernel's default precision would on a TPU, widens the gap (the
  cold solve stops after 18 trips, dfy 1.30 of its max), so bf16 is not
  its cause. On a machine with a GPU

      python -m pytest tests/test_torch_fused_big.py --noconftest -q

  also holds the kernels to the golden under their plan and every plan
  their launchers take: outputs within 1e-4 and cotangents within 1e-3 of
  the golden's largest entry, trips within 3 or 10% of the golden's.
* The slice on the CPU: the port's app at the settings of
  `profile_bench.make_app(232, 2, 1, "cpu", maxiter=200, fused="cuda")`
  (its fused step on the plain versions) against the JAX package's app of
  `__graft_entry__._make_app(232, 2, 1, maxiter=200, fused="pallas")` in
  interpret mode, on the same weights (`params_from_flax`, the CFE's
  output layer perturbed so that OP2 gets a gradient) and batch: the first
  iteration's loss at rtol 1e-4 and each net's gradient at relative norm
  error 1e-3. Both apps have fp32 nets, as `tests/test_torch_fused128.py`
  explains. 232² and not the gate's edge, 236²: the apps' 3-level U-nets
  take neither package's 236² (236 = 4 · 59: their third level's pooling
  and upsampling give 60 rows against 59), and 232 = 8 · 29 is the
  largest square below it that they take; K2 and K3 run banded there.
* The gate: `cuda_fluid.fused_step_fits` says yes exactly where the JAX
  package's `pallas_fluid.fused_step_fits` does, and wherever it does, K2
  and K3 have a plan at every batch.

The golden tests import neither JAX nor the JAX package; the slice's and
the gate's tests import them inside and skip where the JAX package cannot
be imported (the card). At most five tests, so that under `--dist
loadfile` the file goes out with the small ones.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pde_control_tpu_torch.ops import cuda_cg, cuda_fluid

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "goldens" / "fused_step_big.npz"
GRIDS = ((236, 236), (64, 625))
CASES = ("warm-force-inflow", "zero-velocity")
OUTS = ("vy4", "vx4", "rho1", "p")
GRADS = ("vy", "vx", "rho", "fy", "fx", "inflow")
# Per grid: vy4, vx4 and p within `out` of the golden pressure's largest
# entry, each cotangent within `vjp` of its own (the docstring gives the
# differences measured); every grid's trip counts within 3 or 10% of the
# golden's, whichever is more (`chip_smoke.FUSED_BIG_TRIPS`).
LIMITS = {(236, 236): dict(out=5e-6, vjp=5e-5),
          (64, 625): dict(out=3e-5, vjp=5e-4)}
H, N, B = 232, 2, 1
NETS = ("CFE", "OP2")
# The settings of both packages' `_make_app(236, 2, 1, maxiter=200)`.
_CFG = dict(dt=1.0, buoyancy=0.08, pressure_tol=1e-4, pressure_maxiter=200,
            warm_start_pressure=True)
_PDE = dict(control="buoyancy", unet_levels=3, cfe_features=(32, 64, 64, 32),
            op_base_features=16)
_APP = dict(batch_size=B, trainable_networks=NETS, sequence_class="staggered",
            obs_loss_frames=(N,))


def _case(z, h: int, w: int, case: str, dev):
    """The golden's step operands at H x W, output cotangents, settings,
    outputs, input cotangents (None where the case has no such operand)
    and trip counts."""
    grid = f"{h}x{w}"

    def t(key):
        return torch.tensor(z[f"{grid}/{key}"].astype(np.float32), device=dev)

    zero_v = case == "zero-velocity"
    cfg = json.loads(str(z["config"]))
    trips = cfg["trips"][grid][case]
    cfg = {k: cfg[k] for k in ("dt", "dx", "max_shift", "buoyancy", "closed",
                               "tol", "maxiter")}
    state = tuple(torch.zeros_like(t(k)) if zero_v else t(k) for k in ("vy", "vx")
                  ) + (t("rho"),)
    ops = dict(fy=t("fy"), fx=t("fx"), inflow=None if zero_v else t("inflow"),
               x0=None if zero_v else t("x0"))
    geom = tuple(t(k) for k in ("acc_y", "acc_x", "fluid"))
    cots = [t(k) for k in ("g_vy4", "g_vx4", "g_rho1", "g_p")]
    outs = [z[f"{grid}/{case}/{n}"] for n in OUTS]
    grads = [None if zero_v and n == "inflow" else z[f"{grid}/{case}/d_{n}"]
             for n in GRADS]
    return state, ops, geom, cots, cfg, outs, grads, trips


def _within_scale(got, want, limit, label, scale=None):
    got = got.detach().cpu().numpy()
    if scale is None:
        scale = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=limit,
                               err_msg=label)


def _trips_within(got, want, label):
    most = max(3, int(0.1 * max(want)))
    assert int(np.abs(got.cpu().numpy() - np.asarray(want)).max()) <= most, label


def test_plain_fused_step_matches_golden():
    """The golden is whole (the plate in a closed box at each grid,
    float16-exact inputs, finite float32 outputs, every solve stopped by
    the tolerance; both grids banded for K2 and K3); the plain K2 and K3 on
    CPU tensors (no launch) against the JAX package's step and VJP at 236²
    and 64×625, in both cases, at `LIMITS`."""
    z = np.load(GOLDEN)
    cfg = json.loads(str(z["config"]))
    assert cfg["max_shift"] == 2 and cfg["tol"] == 1e-7
    assert [tuple(g) for g in cfg["grids"]] == list(GRIDS)
    for h, w in GRIDS:
        lim = LIMITS[(h, w)]
        fluid = z[f"{h}x{w}/fluid"]
        assert fluid.shape == (h, w) and fluid[h // 2, w // 4:w // 2].sum() == 0
        assert z[f"{h}x{w}/acc_y"][0].sum() == 0  # walls
        assert z[f"{h}x{w}/vy"].dtype == np.float16
        assert (cuda_fluid.fwd_layout(h, w), cuda_fluid.bwd_layout(h, w)) == (
            cuda_cg.BANDED, cuda_cg.BANDED)
        for case in CASES:
            state, ops, geom, cots, kw, outs, grads, trips = _case(
                z, h, w, case, "cpu")
            label = f"{h}x{w} {case}"
            assert 0 < min(trips["fwd"] + trips["bwd"])
            assert max(trips["fwd"] + trips["bwd"]) < kw["maxiter"]
            before = (cuda_fluid.LAUNCHES_FWD, cuda_fluid.LAUNCHES_BWD)
            out = cuda_fluid.fused_step_forward(*state, *geom, **ops, **kw)
            np.testing.assert_allclose(out[2].numpy(), outs[2], atol=5e-6,
                                       rtol=1e-5, err_msg=f"{label} rho1")
            p_max = float(np.abs(outs[3]).max())
            for i in (0, 1, 3):
                _within_scale(out[i], outs[i], lim["out"], f"{label} {OUTS[i]}",
                              scale=p_max)
            _trips_within(out[4], trips["fwd"], f"{label} forward trips")
            got = cuda_fluid.fused_step_backward(
                *state, *cots, *geom, has_force=True,
                has_inflow=ops["inflow"] is not None, **kw)
            for name, a, want in zip(GRADS, got, grads):
                assert (a is None) == (want is None), name
                if a is not None:
                    assert np.isfinite(want).all()
                    _within_scale(a, want, lim["vjp"], f"{label} {name}")
            _trips_within(got[6], trips["bwd"], f"{label} backward trips")
            assert (cuda_fluid.LAUNCHES_FWD, cuda_fluid.LAUNCHES_BWD) == before


@pytest.mark.requires_cuda
def test_kernels_match_golden():
    """K2 and K3 on the card, in the banded layout under their plan and
    every plan their launchers take at 236² and 64×625, against the JAX
    package's step and VJP; each launch counts once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    z = np.load(GOLDEN)
    for h, w in GRIDS:
        for case in CASES:
            state, ops, geom, cots, kw, outs, grads, trips = _case(
                z, h, w, case, dev)
            step_ops = [ops[k] for k in ("fy", "fx", "inflow", "x0")]
            for plan in [None] + cuda_fluid.fwd_plans(h, w):
                label = f"{h}x{w} {case} {plan}"
                before = cuda_fluid.LAUNCHES_FWD
                out = cuda_fluid._launch_forward(*state, *geom, *step_ops,
                                                 plan, **kw)
                torch.cuda.synchronize()
                assert cuda_fluid.LAUNCHES_FWD == before + 1
                for name, got, want in zip(OUTS, out, outs):
                    _within_scale(got, want, 1e-4, f"{label} {name}")
                _trips_within(out[4], trips["fwd"], f"{label} forward trips")
            for plan in [None] + cuda_fluid.bwd_plans(h, w):
                label = f"{h}x{w} {case} {plan}"
                before = cuda_fluid.LAUNCHES_BWD
                got = cuda_fluid._launch_backward(
                    *state, *cots, *geom, plan, has_force=True,
                    has_inflow=ops["inflow"] is not None, **kw)
                torch.cuda.synchronize()
                assert cuda_fluid.LAUNCHES_BWD == before + 1
                for name, a, want in zip(GRADS, got, grads):
                    assert (a is None) == (want is None), name
                    if a is not None:
                        _within_scale(a, want, 1e-3, f"{label} {name}")
                _trips_within(got[6], trips["bwd"], f"{label} backward trips")


def _plate(n: int) -> np.ndarray:
    m = np.zeros((n, n), np.float32)
    m[n // 2, n // 4:n // 2] = 1.0
    return m


def _batch():
    """`__graft_entry__._make_batch(232, 2, 1)`."""
    from pde_control_tpu_torch.experiments import profile_bench

    return profile_bench.make_batch(H, N, B)


def _perturbed(params):
    """A nonzero CFE output layer (0.05·N(0, 1) from a numpy seed, as
    `tests/test_torch_fused128.py` loads), so that a gradient reaches
    OP2."""
    k = params["CFE"]["Conv_4"]["kernel"]
    params["CFE"]["Conv_4"]["kernel"] = (
        0.05 * np.random.default_rng(3).normal(size=k.shape)).astype(np.float32)
    return params


@functools.lru_cache(maxsize=1)
def _jax_iteration():
    """The JAX package's first iteration at the settings of `_make_app(232,
    2, 1, maxiter=200, fused='pallas')` with fp32 nets, its fused step in
    interpret mode on the CPU: its loss, its gradients (converted to the
    port's names) and its weights. Called once per module; skips where the
    JAX package cannot be imported."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    pytest.importorskip("pde_control_tpu.control.training")
    from pde_control_tpu.control.pde_fluid import IncompressibleFluidPDE
    from pde_control_tpu.control.training import ControlTraining
    from pde_control_tpu.grids import Domain2D
    from pde_control_tpu.physics.fluid import FluidConfig
    from pde_control_tpu_torch import params_from_flax

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
    """The 232² first iteration under fused='cuda' (one K2 and one K3 a
    step, plain on the CPU) against the JAX package's fused='pallas'."""
    jloss, _, _ = _jax_iteration()
    tloss, _, calls = _port_iteration()
    assert calls.count("fused_step_plain_forward") == N
    assert calls.count("fused_step_plain_backward") == N
    assert np.isfinite(tloss)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)


def test_slice_gradients_match_jax():
    """Each trained net's gradient (CFE, OP2) at relative norm error 1e-3."""
    _, jgrads, _ = _jax_iteration()
    _, tgrads, _ = _port_iteration()
    for net in NETS:
        tg = torch.cat([g.reshape(-1) for g in tgrads[net].values()])
        jg = torch.cat([jgrads[net][k].reshape(-1) for k in tgrads[net]])
        assert float(jg.norm()) > 0 and float(tg.norm()) > 0, net
        assert float((tg - jg).norm() / jg.norm()) < 1e-3, net


# A stand-in for cudaOccupancyMaxActiveClusters on a 132-SM card that holds
# one block an SM (`tests/test_torch_kernels.py`'s).
def _resident_clusters(cluster, threads, shared_bytes):
    return 132 // cluster


def test_gate_is_the_pallas_gate_with_plans_at_every_batch():
    """`fused_step_fits(h, w)` equals the JAX package's
    `pallas_fluid.fused_step_fits(h, w)` on every height of its domain, at
    every third width and at each height's last admitted width and the
    next; and each admitted grid of a coarser sweep, each height's widest
    and each width's tallest, has a plan of K2 and of K3 at batches 1 to
    1000. 237² and 256² are refused
    though plans fit there."""
    pallas_fluid = pytest.importorskip("pde_control_tpu.ops.pallas_fluid")
    gate = pallas_fluid.fused_step_fits
    edges, n_admitted = [], 0
    for w in range(1, 1100):  # each width's tallest admitted grid
        last = max((h for h in range(1, 440) if gate(h, w)), default=0)
        edges += [(last, w)] if last else []
    for h in range(1, 440):
        last = max((w for w in range(1, 1100) if gate(h, w)), default=0)
        edges += [(h, last)] if last else []
        for w in sorted(set(range(1, last + 6, 3)) | {last, last + 1}):
            fits = gate(h, w)
            n_admitted += fits
            assert cuda_fluid.fused_step_fits(h, w) is fits, (h, w)
    assert n_admitted > 45_000
    assert gate(236, 236) and not gate(237, 237)
    grids = [(h, w) for h in range(1, 440, 7) for w in range(1, 1000, 13)
             if gate(h, w)]
    for h, w in grids + edges:
        assert cuda_fluid.fused_step_fits(h, w), (h, w)
        for b in (1, 2, 8, 64, 132, 1000):
            assert cuda_fluid.fwd_plan(b, h, w, sm_count=132,
                                       max_clusters=_resident_clusters)
            assert cuda_fluid.bwd_plan(b, h, w, sm_count=132,
                                       max_clusters=_resident_clusters)
    for n in (237, 256):
        assert cuda_fluid.fwd_plans(n, n) and cuda_fluid.bwd_plans(n, n)
        assert not cuda_fluid.fused_step_fits(n, n)
