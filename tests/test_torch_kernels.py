"""The port's CUDA kernels against their plain torch versions, on the card:
the pressure solve (K1, `ops/cuda_cg.py`), the fused fluid step's forward
and backward (K2 and K3, `ops/cuda_fluid.py`) and the 3×3 conv's forward
and input gradient (K4) and weight gradient (K5, `ops/cuda_conv.py`).

This file imports neither JAX nor the JAX package, so it also runs where
only the port's dependencies are installed. On a machine with a GPU:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(`--noconftest` skips tests/conftest.py, which configures JAX.) Without a
CUDA device the kernel tests skip; the wrapper's checks run anywhere.
"""

import numpy as np
import pytest
import torch

from pde_control_tpu_torch.grids import Domain2D
from pde_control_tpu_torch.ops import cuda_cg, cuda_conv, cuda_fluid
from pde_control_tpu_torch.physics.poisson import solve_pressure

torch.set_num_threads(1)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _plate(n):
    m = np.zeros((n, n), np.float32)
    m[n // 2, n // 4:n // 2] = 1.0
    return m


@pytest.mark.parametrize("n,closed", [(64, True), (32, False), (48, True)])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.requires_cuda
def test_kernel_matches_plain(n, closed, warm):
    """Solution within 1e-3 of the plain version's scale at tol 1e-6, trip
    counts within 3 (the order of summation differs)."""
    dev = _cuda()
    rng = np.random.default_rng(0)
    domain = Domain2D.create(n, n, obstacle_mask=_plate(n), closed=closed,
                             device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    div = torch.tensor(rng.normal(size=(8, n, n)), dtype=torch.float32, device=dev)
    x0 = (torch.tensor(rng.normal(size=(8, n, n)), dtype=torch.float32,
                       device=dev) if warm else None)
    args = dict(x0=x0, closed=closed, tol=1e-6, maxiter=500)
    before = cuda_cg.LAUNCHES
    p_k, it_k = cuda_cg.pressure_solve(div, *geom, **args)
    p_p, it_p = cuda_cg.pcg_plain(div, *geom, **args)
    torch.cuda.synchronize()
    assert cuda_cg.LAUNCHES == before + 1
    assert float((p_k - p_p).abs().max() / p_p.abs().max()) < 1e-3
    assert int((it_k - it_p).abs().max()) <= 3


# (n, closed, preconditioned) of the K1 plan sweep: the main path's grid,
# an open box, a grid the bands do not divide evenly, the largest square
# grid of the small layout held to plain, the large layout's smallest grid
# (bands of 7 rows at C = 16) and the largest the gate holds to plain
# (smoke_128's), open too, and the unpreconditioned loop closed and open,
# in both layouts.
_SOLVE_PLAN_CASES = [(64, True, True), (32, False, True), (48, True, True),
                     (96, True, True), (112, True, True), (128, True, True),
                     (128, False, True), (32, True, False), (32, False, False),
                     (128, True, False)]


@pytest.mark.parametrize("n,closed,precond", _SOLVE_PLAN_CASES)
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.requires_cuda
def test_kernel_plans_match_plain(n, closed, precond, warm):
    """K1 under every plan its launcher takes: the solution within 1e-3 of
    the plain version's scale at tol 1e-6, trip counts within 3, the same
    bits in two calls; each launch counts once."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    domain = Domain2D.create(n, n, obstacle_mask=_plate(n), closed=closed,
                             device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    div = torch.tensor(rng.normal(size=(4, n, n)), dtype=torch.float32, device=dev)
    x0 = (torch.tensor(rng.normal(size=(4, n, n)), dtype=torch.float32,
                       device=dev) if warm else None)
    kw = dict(dx=1.0, closed=closed, tol=1e-6, maxiter=500, precond=precond)
    p_p, it_p = cuda_cg.pcg_plain(div, *geom, x0, **kw)
    plans = cuda_cg.solve_plans(n, n)
    assert plans and cuda_cg.solve_plan(4, n, n) in plans
    for plan in plans:
        before = cuda_cg.LAUNCHES
        (p_k, it_k), (again, it_again) = (
            cuda_cg._launch_solve(div, *geom, x0, plan, **kw) for _ in range(2))
        torch.cuda.synchronize()
        assert cuda_cg.LAUNCHES == before + 2, plan
        assert float((p_k - p_p).abs().max() / p_p.abs().max()) < 1e-3, plan
        assert int((it_k - it_p).abs().max()) <= 3, plan
        assert torch.equal(p_k.view(torch.int32), again.view(torch.int32)), plan
        assert torch.equal(it_k, it_again), plan


@pytest.mark.requires_cuda
def test_solve_launcher_refuses_a_plan_it_cannot_run():
    """A cluster size the launcher does not take, or one above H, raises
    and launches nothing."""
    dev = _cuda()
    domain = Domain2D.create(8, 8, device=dev)
    div = torch.zeros(2, 8, 8, device=dev)
    before = cuda_cg.LAUNCHES
    for plan in (cuda_cg.ClusterPlan(3, 512, 3, 4096),
                 cuda_cg.ClusterPlan(16, 512, 1, 4096),
                 cuda_cg.ClusterPlan(2, 256, 4, 4096)):
        with pytest.raises(RuntimeError, match="cudaError"):
            cuda_cg._launch_solve(div, domain.acc_y, domain.acc_x,
                                  domain.fluid_mask, None, plan, dx=1.0,
                                  closed=True, tol=1e-5, maxiter=10,
                                  precond=True)
    assert cuda_cg.LAUNCHES == before


@pytest.mark.requires_cuda
def test_kernel_gradient_matches_plain():
    dev = _cuda()
    rng = np.random.default_rng(1)
    domain = Domain2D.create(64, 64, obstacle_mask=_plate(64), device=dev)
    div = torch.tensor(rng.normal(size=(4, 64, 64)), dtype=torch.float32, device=dev)
    w = torch.tensor(rng.normal(size=(4, 64, 64)), dtype=torch.float32, device=dev)
    grads = []
    for backend in ("cuda", "pcg"):
        d = div.clone().requires_grad_(True)
        (solve_pressure(d, domain, tol=1e-6, backend=backend) * w).sum().backward()
        grads.append(d.grad)
    assert float((grads[0] - grads[1]).abs().max() / grads[1].abs().max()) < 1e-3


@pytest.mark.parametrize("h,w", [(64, 64), (32, 48), (128, 128), (256, 256)])
@pytest.mark.requires_cuda
def test_shared_memory_count_matches_source(h, w):
    """K1's plans count the bytes the kernel's source asks for, under every
    plan its launcher takes and under `solve_plan`'s, and name the layout
    the source takes (the large one at 128², the banded one at 256²)."""
    import ctypes

    from pde_control_tpu_torch.ops import _build

    _cuda()
    lib = _build.load()[0]
    fn = lib.pcg_shared_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_size_t
    layout = lib.pcg_layout
    layout.argtypes, layout.restype = [ctypes.c_int] * 3, ctypes.c_int
    for plan in cuda_cg.solve_plans(h, w) + [cuda_cg.solve_plan(8, h, w)]:
        assert fn(h, w, plan.cluster, plan.threads) == plan.shared_bytes
    want = {128: cuda_cg.LARGE, 256: cuda_cg.BANDED}.get(h, cuda_cg.SMALL)
    assert layout(h, w, cuda_cg.CLUSTER_THREADS) == want
    assert cuda_cg.layout(h, w) == want


@pytest.mark.requires_cuda
def test_kernel_rejects_bad_inputs():
    dev = _cuda()
    domain = Domain2D.create(64, 64, obstacle_mask=_plate(64), device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    div = torch.zeros(2, 64, 64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        cuda_cg.pressure_solve(div.double(), *geom)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cg.pressure_solve(div.transpose(1, 2), *geom)
    with pytest.raises(ValueError, match="shape"):
        cuda_cg.pressure_solve(div, domain.acc_x, domain.acc_y, domain.fluid_mask)
    big = Domain2D.create(8, 8192, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_cg.pressure_solve(torch.zeros(1, 8, 8192, device=dev), big.acc_y,
                               big.acc_x, big.fluid_mask)


def test_wrapper_takes_cpu_and_cuda_only():
    domain = Domain2D.create(8, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_cg.pressure_solve(torch.zeros(1, 8, 8, device="meta"), domain.acc_y,
                               domain.acc_x, domain.fluid_mask)


def test_cpu_tensors_run_the_plain_version():
    domain = Domain2D.create(8, 8, obstacle_mask=_plate(8), device="cpu")
    div = torch.tensor(np.random.default_rng(2).normal(size=(2, 8, 8)),
                       dtype=torch.float32)
    before = cuda_cg.LAUNCHES
    p, it = cuda_cg.pressure_solve(div, domain.acc_y, domain.acc_x,
                                   domain.fluid_mask, tol=1e-6)
    p_ref, it_ref = cuda_cg.pcg_plain(div, domain.acc_y, domain.acc_x,
                                      domain.fluid_mask, tol=1e-6)
    assert cuda_cg.LAUNCHES == before  # no kernel on the CPU
    assert torch.equal(p, p_ref) and torch.equal(it, it_ref)


@pytest.mark.parametrize("h,w,fits", [(64, 64, True), (96, 96, True),
                                      (32, 48, True), (64, 128, True),
                                      (128, 128, True), (136, 136, True),
                                      (160, 160, True), (362, 362, True),
                                      (8, 1000, True), (402, 402, False),
                                      (8, 8192, False)])
def test_solve_fits_gate(h, w, fits):
    """K1 takes a grid where some plan of its layout fits shared memory:
    every grid the Pallas gate admits (`tests/test_torch_pcg_big.py`
    sweeps it) and wider ones, not 402² or 8×8192."""
    assert cuda_cg.cuda_solve_fits(h, w) is fits


# ---------------------------------------------------------------- K2 / K3

_FUSED = dict(dt=1.0, dx=1.0, max_shift=2, buoyancy=0.08, closed=True, tol=1e-6,
              maxiter=500)
# (warm start, force, inflow, zero velocity, a NaN in sample 0's vy and an
# infinity in sample 1's vx)
_FUSED_CASES = {"cold-force": (False, True, False, False, False),
                "warm-force-inflow": (True, True, True, False, False),
                "zero-velocity": (False, True, False, True, False),
                "non-finite": (False, True, False, False, True)}


def _fused_inputs(n, case, dev, batch=8, seed=0, w=None):
    """The step's operands and the four cotangents on an n x w grid (w = n
    by default), from a numpy seed."""
    warm, force, inflow, zero_v, nonfinite = _FUSED_CASES[case]
    rng = np.random.default_rng(seed)
    h, w = n, n if w is None else w

    def t(*shape, scale=1.0, uniform=False):
        a = rng.uniform(0, 1, shape) if uniform else rng.normal(size=shape)
        return torch.tensor(scale * a, dtype=torch.float32, device=dev)

    v = 0.0 if zero_v else 0.5
    ops = dict(vy=t(batch, h + 1, w, scale=v), vx=t(batch, h, w + 1, scale=v),
               rho=t(batch, h, w, uniform=True))
    if nonfinite:
        ops["vy"][0, h // 2, w // 3] = float("nan")
        ops["vx"][1, h // 3, w // 2] = float("inf")
    if force:
        ops.update(fy=t(batch, h + 1, w, scale=0.05),
                   fx=t(batch, h, w + 1, scale=0.05))
    if inflow:
        ops["inflow"] = t(batch, h, w, scale=0.05, uniform=True)
    if warm:
        ops["x0"] = t(batch, h, w, scale=0.5)
    cots = [t(batch, h + 1, w), t(batch, h, w + 1), t(batch, h, w),
            t(batch, h, w)]
    return ops, cots


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _agree(a, b, limit, nonfinite):
    """The non-finite cells are the plain version's (none unless some were
    planted); the finite ones agree within `limit` of its scale."""
    fin = torch.isfinite(b)
    assert torch.equal(torch.isfinite(a), fin)
    assert nonfinite or fin.all()
    assert _rel(a[fin], b[fin]) < limit


# The cluster sizes whose shared memory holds K2's and K3's blocks at the
# larger grids of the plan tests; at the others every size up to H does.
_FUSED_CLUSTERS = {("fwd", 110, 110): {4, 8, 16}, ("fwd", 127, 127): {8, 16},
                   ("bwd", 110, 110): {16}, ("bwd", 127, 127): {8, 16}}


def _check_backward_plans(vy, vx, rho, cots, geom, flags, nonfinite, want):
    """K3 under every plan the launcher takes (every cluster size up to H,
    or those of `_FUSED_CLUSTERS`): each cotangent within 1e-3 of the
    plain version's scale with its non-finite cells, trip counts within 3,
    the same bits in two calls; each launch counts once."""
    h, w = rho.shape[1:]
    plans = cuda_fluid.bwd_plans(h, w)
    assert {p.cluster for p in plans} == _FUSED_CLUSTERS.get(
        ("bwd", h, w), {c for c in cuda_fluid.BWD_CLUSTERS if c <= h})
    for plan in plans:
        before = cuda_fluid.LAUNCHES_BWD
        got, again = (cuda_fluid._launch_backward(vy, vx, rho, *cots, *geom,
                                                  plan, **flags, **_FUSED)
                      for _ in range(2))
        torch.cuda.synchronize()
        assert cuda_fluid.LAUNCHES_BWD == before + 2, plan
        for a, b, c in zip(got[:6], want[:6], again[:6]):
            assert (a is None) == (b is None), plan
            if a is not None:
                _agree(a, b, 1e-3, nonfinite)
                assert torch.equal(a.view(torch.int32), c.view(torch.int32)), plan
        assert int((got[6] - want[6]).abs().max()) <= 3, plan
        assert torch.equal(got[6], again[6]), plan


def _check_forward_plans(vy, vx, rho, ops, geom, nonfinite, want):
    """K2 under every plan the launcher takes (every cluster size up to H,
    or those of `_FUSED_CLUSTERS`): each output within 1e-4 of the plain
    version's scale with its non-finite cells, trip counts within 3, the
    same bits in two calls; each launch counts once."""
    h, w = rho.shape[1:]
    plans = cuda_fluid.fwd_plans(h, w)
    assert {p.cluster for p in plans} == _FUSED_CLUSTERS.get(
        ("fwd", h, w), {c for c in cuda_cg.CLUSTERS if c <= h})
    for plan in plans:
        before = cuda_fluid.LAUNCHES_FWD
        got, again = (cuda_fluid._launch_forward(
            vy, vx, rho, *geom, ops.get("fy"), ops.get("fx"), ops.get("inflow"),
            ops.get("x0"), plan, **_FUSED) for _ in range(2))
        torch.cuda.synchronize()
        assert cuda_fluid.LAUNCHES_FWD == before + 2, plan
        for a, b, c in zip(got[:4], want[:4], again[:4]):
            _agree(a, b, 1e-4, nonfinite)
            assert torch.equal(a.view(torch.int32), c.view(torch.int32)), plan
        assert int((got[4] - want[4]).abs().max()) <= 3, plan
        assert torch.equal(got[4], again[4]), plan


@pytest.mark.parametrize("n", [64, 32])
@pytest.mark.parametrize("case", list(_FUSED_CASES))
@pytest.mark.requires_cuda
def test_fused_kernels_match_plain(n, case):
    """K2's outputs within 1e-4 of the plain version's scale and its trip
    counts within 3; K3's cotangents within 1e-3; each under its plan
    (`fwd_plan`, `bwd_plan`) and under every cluster size its launcher
    takes, the same bits in two calls; non-finite cells where the plain
    version has them. Each launch counts once."""
    nonfinite = _FUSED_CASES[case][4]
    dev = _cuda()
    domain = Domain2D.create(n, n, obstacle_mask=_plate(n), device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    ops, cots = _fused_inputs(n, case, dev)
    vy, vx, rho = ops.pop("vy"), ops.pop("vx"), ops.pop("rho")
    before = cuda_fluid.LAUNCHES_FWD
    out_k = cuda_fluid.fused_step_forward(vy, vx, rho, *geom, **ops, **_FUSED)
    out_p = cuda_fluid.fused_step_plain_forward(vy, vx, rho, *geom, **ops,
                                                **_FUSED)
    torch.cuda.synchronize()
    assert cuda_fluid.LAUNCHES_FWD == before + 1
    for a, b in zip(out_k[:4], out_p[:4]):
        _agree(a, b, 1e-4, nonfinite)
    assert int((out_k[4] - out_p[4]).abs().max()) <= 3
    _check_forward_plans(vy, vx, rho, ops, geom, nonfinite, out_p)
    flags = dict(has_force="fy" in ops, has_inflow="inflow" in ops)
    before = cuda_fluid.LAUNCHES_BWD
    g_k = cuda_fluid.fused_step_backward(vy, vx, rho, *cots, *geom, **flags,
                                         **_FUSED)
    g_p = cuda_fluid.fused_step_plain_backward(vy, vx, rho, *cots, *geom,
                                               **flags, **_FUSED)
    torch.cuda.synchronize()
    assert cuda_fluid.LAUNCHES_BWD == before + 1
    for a, b in zip(g_k[:6], g_p[:6]):
        assert (a is None) == (b is None)
        if a is not None:
            _agree(a, b, 1e-3, nonfinite)
    assert int((g_k[6] - g_p[6]).abs().max()) <= 3
    _check_backward_plans(vy, vx, rho, cots, geom, flags, nonfinite, g_p)


@pytest.mark.parametrize("h,w", [(32, 48), (8, 8), (24, 30), (110, 110),
                                 (127, 127)])
@pytest.mark.parametrize("case", list(_FUSED_CASES))
@pytest.mark.requires_cuda
def test_fused_backward_plans_match_plain(h, w, case):
    """K3 at a grid that is not square, at one smaller than a 16-rank
    cluster's halo, at a width that is not a multiple of 4 (the bands
    are pushed by scalars, not float4), at 110² (the small layout, beside
    K2's large one) and at 127² (the large layout, its bands of unequal
    rows under C = 8 and 16), under every plan the launcher takes, against
    the plain version (limits as above)."""
    dev = _cuda()
    plate = np.zeros((h, w), np.float32)
    plate[h // 2, w // 4:w // 2] = 1.0
    domain = Domain2D.create(h, w, obstacle_mask=plate, device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    ops, cots = _fused_inputs(h, case, dev, w=w)
    vy, vx, rho = ops.pop("vy"), ops.pop("vx"), ops.pop("rho")
    flags = dict(has_force="fy" in ops, has_inflow="inflow" in ops)
    want = cuda_fluid.fused_step_plain_backward(vy, vx, rho, *cots, *geom,
                                                **flags, **_FUSED)
    _check_backward_plans(vy, vx, rho, cots, geom, flags, _FUSED_CASES[case][4],
                          want)


@pytest.mark.parametrize("h,w", [(32, 48), (8, 8), (24, 30), (110, 110),
                                 (127, 127)])
@pytest.mark.parametrize("case", list(_FUSED_CASES))
@pytest.mark.requires_cuda
def test_fused_forward_plans_match_plain(h, w, case):
    """K2 at a grid that is not square, at one row a rank under a cluster
    of 8 (the windows reach past the neighbours' bands), at a width that
    is not a multiple of 4, and in the large layout at 110² (beside K3's
    small one) and 127² (its bands of unequal rows under C = 8 and 16),
    under every plan the launcher takes, against the plain version (limits
    as above)."""
    dev = _cuda()
    plate = np.zeros((h, w), np.float32)
    plate[h // 2, w // 4:w // 2] = 1.0
    domain = Domain2D.create(h, w, obstacle_mask=plate, device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    ops, _ = _fused_inputs(h, case, dev, w=w)
    vy, vx, rho = ops.pop("vy"), ops.pop("vx"), ops.pop("rho")
    want = cuda_fluid.fused_step_plain_forward(vy, vx, rho, *geom, **ops,
                                               **_FUSED)
    _check_forward_plans(vy, vx, rho, ops, geom, _FUSED_CASES[case][4], want)


@pytest.mark.parametrize("h,w", [(64, 64), (32, 48), (96, 96), (110, 110),
                                 (112, 112), (127, 127), (128, 128),
                                 (236, 236), (8, 990)])
@pytest.mark.requires_cuda
def test_fused_shared_memory_count_matches_source(h, w):
    """K2's and K3's plans count the bytes the kernels' source asks for,
    under every plan their launchers take and under their plan at batch 8:
    `fused_fwd_shared_bytes` and `fused_bwd_shared_bytes`, in the layout
    the grid takes, which `fused_fwd_layout` and `fused_bwd_layout` report
    as `fwd_layout` and `bwd_layout` do (small at 64², 32×48 and 96²; at
    110² K2 large and K3 small; large from 112² to 128²; banded at 236²;
    at 8×990 K2 large and K3 banded), and K3's banded scratch as
    `fused_bwd_scratch_floats` counts it."""
    import ctypes

    from pde_control_tpu_torch.ops import _build

    _cuda()
    lib = _build.load()[0]
    fn = lib.fused_fwd_shared_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_size_t
    for plan in cuda_fluid.fwd_plans(h, w) + [cuda_fluid.fwd_plan(8, h, w)]:
        assert fn(h, w, plan.cluster, plan.threads) == plan.shared_bytes
    fn = lib.fused_bwd_shared_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_size_t
    for plan in cuda_fluid.bwd_plans(h, w) + [cuda_fluid.bwd_plan(8, h, w)]:
        assert fn(h, w, plan.cluster, plan.threads, 2) == plan.shared_bytes
    layout = lib.fused_fwd_layout
    layout.argtypes, layout.restype = [ctypes.c_int] * 3, ctypes.c_int
    assert layout(h, w, 512) == cuda_fluid.fwd_layout(h, w)
    layout = lib.fused_bwd_layout
    layout.argtypes, layout.restype = [ctypes.c_int] * 4, ctypes.c_int
    assert layout(h, w, 512, 2) == cuda_fluid.bwd_layout(h, w, 2)
    fn = lib.fused_bwd_scratch_floats
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_size_t
    for plan in cuda_fluid.bwd_plans(h, w):
        assert fn(h, w, plan.cluster, plan.threads, 2) == (
            cuda_fluid.bwd_scratch_floats(h, w, plan.cluster, 2))
    sides = {(8, 990): (cuda_cg.LARGE, cuda_cg.BANDED)}
    assert (cuda_fluid.fwd_layout(h, w), cuda_fluid.bwd_layout(h, w, 2)) == (
        sides.get((h, w)) or tuple(
            cuda_cg.BANDED if h >= banded else cuda_cg.LARGE if h >= large
            else cuda_cg.SMALL for large, banded in ((109, 146), (112, 152))))


@pytest.mark.parametrize("h,w,fwd,bwd", [
    (104, 104, False, False), (108, 108, False, False),
    (109, 109, True, False), (111, 111, True, False), (112, 112, True, True),
    (128, 128, True, True), (64, 128, False, False), (128, 64, False, False)])
def test_fused_large_layout_sides(h, w, fwd, bwd):
    """Where K2 and K3 take the cluster core's large layout: where the
    small one fits a block under no cluster size, K2 from 109², K3 (whose
    window phase also shares the block) from 112²; a 64×128 or 128×64 grid
    keeps the small layout. Every plan of a grid counts its layout, and
    the large layout fits at 128² under C = 8 and 16, not 4."""
    assert cuda_fluid.fwd_layout(h, w) == int(fwd)
    assert cuda_fluid.bwd_layout(h, w, 2) == int(bwd)
    for c in cuda_cg.CLUSTERS:
        assert cuda_fluid.fwd_shared_bytes(h, w, c, 512) == (
            cuda_fluid._fwd_bytes(h, w, c, 512, fwd))
        assert cuda_fluid.bwd_shared_bytes(h, w, c, 512, 2) == (
            cuda_fluid._bwd_bytes(h, w, c, 512, 2, bwd))
    if (h, w) == (128, 128):
        assert [p.cluster for p in cuda_fluid.fwd_plans(h, w)] == [8, 16]
        assert [p.cluster for p in cuda_fluid.bwd_plans(h, w)] == [8, 16]


@pytest.mark.parametrize("kind,h,w", sorted(_FUSED_CLUSTERS))
def test_fused_plan_clusters_at_large_grids(kind, h, w):
    """The cluster sizes the plan tests run at 110² and 127²: K2 at 110²
    (large layout) from C = 4, K3 there (small layout) at C = 16 only; both
    at 127² (large layout, bands of 15 or 16 rows under C = 8) from C = 8."""
    plans = (cuda_fluid.fwd_plans if kind == "fwd" else cuda_fluid.bwd_plans)(
        h, w)
    assert {p.cluster for p in plans} == _FUSED_CLUSTERS[(kind, h, w)]


# A stand-in for cudaOccupancyMaxActiveClusters on a 132-SM card that holds
# one block an SM.
def _resident_clusters(cluster, threads, shared_bytes):
    return 132 // cluster


def _no_resident_16(cluster, threads, shared_bytes):
    return 7 if cluster == 16 else _resident_clusters(cluster, threads,
                                                      shared_bytes)


_BWD_PLAN_SHAPES = [(1, 8, 8), (8, 64, 64), (64, 64, 64), (8, 32, 48),
                    (8, 84, 84), (2, 8, 8), (8, 96, 96), (8, 112, 112),
                    (8, 128, 128), (200, 128, 128), (8, 64, 128)]


def _check_bands(plans, h):
    """Under every plan, the ranks' bands (pcg_cluster.cuh :: Band: rank c
    owns cell and x-face rows [cH/C, (c+1)H/C), the last rank also y-face
    row H) cover each row of the cell, y-face and x-face fields exactly
    once, none is empty, none is longer than `rows_per_rank`, and each
    row's owner is found from the row alone."""
    for p in plans:
        c = p.cluster
        cells, y_faces = np.zeros(h, int), np.zeros(h + 1, int)
        for rank in range(c):
            a, b = rank * h // c, (rank + 1) * h // c
            assert 1 <= b - a <= p.rows_per_rank == -(-h // c)
            cells[a:b] += 1
            y_faces[a:h + 1 if rank == c - 1 else b] += 1
            for r in range(a, b):
                assert min(((r + 1) * c - 1) // h, c - 1) == rank
        assert (cells == 1).all() and (y_faces == 1).all()  # x-faces: cells


@pytest.mark.parametrize("batch,h,w", _BWD_PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in _BWD_PLAN_SHAPES])
def test_bwd_plan_covers_the_rows_once(batch, h, w):
    """K3's plan: a cluster size the launcher takes, shared memory within a
    block's limit and equal to `bwd_shared_bytes`; and under it and every
    other cluster size that fits, the ranks' bands (pcg_cluster.cuh ::
    Band: rank c owns cell and x-face rows [cH/C, (c+1)H/C), the last rank
    also y-face row H) cover each row of the cell, y-face and x-face fields
    exactly once, none is empty, none is longer than `rows_per_rank`, and
    each row's owner is found from the row alone."""
    plan = cuda_fluid.bwd_plan(batch, h, w, sm_count=132,
                               max_clusters=_resident_clusters)
    assert plan.cluster in (1, 2, 4, 8, 16) and plan.cluster <= h
    assert plan.threads == cuda_fluid.BWD_THREADS
    assert plan.shared_bytes == cuda_fluid.bwd_shared_bytes(
        h, w, plan.cluster, plan.threads, 2) <= cuda_cg.SMEM_LIMIT_BYTES
    plans = cuda_fluid.bwd_plans(h, w)
    assert plan in plans
    _check_bands(plans, h)


def test_bwd_plan_fills_the_card_and_is_cached():
    """The smallest cluster size whose clusters fill a 132-SM card (16 at
    batch 8 and below, capped at H rows), the next smaller one while the
    card cannot hold `batch` clusters at once (8 when only 7 clusters of 16
    fit; 2 at batch 64), the smallest that fits shared memory at large
    batch (8 at 128², in the large layout, where 4 does not fit); one plan
    object per shape; no plan beyond shared memory (8×8192: the banded
    layout, whose window phase is in global memory, fits 8×4096)."""
    def plan(batch, h, w, limit=_resident_clusters):
        return cuda_fluid.bwd_plan(batch, h, w, sm_count=132, max_clusters=limit)

    assert plan(8, 64, 64).cluster == 16
    assert plan(1, 8, 8).cluster == 8
    assert plan(8, 64, 64, _no_resident_16).cluster == 8
    assert plan(64, 64, 64).cluster == 2
    assert plan(132, 64, 64).cluster == 1
    assert plan(200, 84, 84).cluster == 2  # one block per sample does not fit
    assert plan(8, 84, 84).cluster == 16
    assert plan(8, 128, 128).cluster == 16
    assert plan(8, 128, 128, _no_resident_16).cluster == 8
    assert plan(200, 128, 128).cluster == 8
    assert plan(8, 64, 64) is plan(8, 64, 64)
    with pytest.raises(ValueError, match="shared memory"):
        plan(1, 8, 8192)


_SOLVE_PLAN_SHAPES = [(1, 8, 8), (8, 64, 64), (64, 64, 64), (8, 32, 48),
                      (8, 96, 96), (2, 8, 8), (200, 96, 96), (8, 112, 112),
                      (8, 128, 128), (200, 128, 128), (8, 257, 257),
                      (8, 320, 96), (1, 8, 1000)]


@pytest.mark.parametrize("batch,h,w", _SOLVE_PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in _SOLVE_PLAN_SHAPES])
def test_solve_plan_covers_the_rows_once(batch, h, w):
    """K1's plan: a cluster size the launcher takes, 512 threads, shared
    memory within a block's limit and equal to `solve_shared_bytes`; and
    under it and every other plan, bands as `_check_bands` holds them."""
    plan = cuda_cg.solve_plan(batch, h, w, sm_count=132,
                              max_clusters=_resident_clusters)
    assert plan.cluster in cuda_cg.CLUSTERS and plan.cluster <= h
    assert plan.threads == cuda_cg.CLUSTER_THREADS
    assert plan.shared_bytes == cuda_cg.solve_shared_bytes(
        h, w, plan.cluster, plan.threads) <= cuda_cg.SMEM_LIMIT_BYTES
    plans = cuda_cg.solve_plans(h, w)
    assert plan in plans
    _check_bands(plans, h)


def test_solve_plan_fills_the_card_and_is_cached():
    """K1's plan by the rule of K3's (`cuda_cg.pick_plan`): 16 at 64²×8
    where 8 clusters of 16 fit, else 8; 2 at batch 64; 1 at batch 132; the
    smallest that fits shared memory at a large batch (4 at 96² and 128²);
    at 128²×8 and 256²×8 (banded, C = 8 or 16) as at 64²×8; 16 at 351²,
    where only 16 fits; capped at H rows; one plan object per shape; no
    plan beyond shared memory."""
    def plan(batch, h, w, limit=_resident_clusters):
        return cuda_cg.solve_plan(batch, h, w, sm_count=132, max_clusters=limit)

    assert plan(8, 64, 64).cluster == 16
    assert plan(8, 64, 64, _no_resident_16).cluster == 8
    assert plan(64, 64, 64).cluster == 2
    assert plan(132, 64, 64).cluster == 1
    assert plan(1, 8, 8).cluster == 8
    assert plan(200, 96, 96).cluster == 4
    assert plan(8, 128, 128).cluster == 16
    assert plan(8, 128, 128, _no_resident_16).cluster == 8
    assert plan(200, 128, 128).cluster == 4
    assert plan(8, 256, 256).cluster == 16  # banded: C = 8 or 16
    assert plan(8, 256, 256, _no_resident_16).cluster == 8
    assert plan(8, 351, 351, _no_resident_16).cluster == 16  # 16 only
    assert plan(8, 64, 64) is plan(8, 64, 64)
    with pytest.raises(ValueError, match="shared memory"):
        plan(1, 8, 8192)


@pytest.mark.parametrize("batch,h,w", _BWD_PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in _BWD_PLAN_SHAPES])
def test_fwd_plan_covers_the_rows_once(batch, h, w):
    """K2's plan: a cluster size the launcher takes, 512 threads, shared
    memory within a block's limit and equal to `fwd_shared_bytes`; and
    under it and every other plan, bands as `_check_bands` holds them."""
    plan = cuda_fluid.fwd_plan(batch, h, w, sm_count=132,
                               max_clusters=_resident_clusters)
    assert plan.cluster in cuda_cg.CLUSTERS and plan.cluster <= h
    assert plan.threads == cuda_cg.CLUSTER_THREADS
    assert plan.shared_bytes == cuda_fluid.fwd_shared_bytes(
        h, w, plan.cluster, plan.threads) <= cuda_cg.SMEM_LIMIT_BYTES
    plans = cuda_fluid.fwd_plans(h, w)
    assert plan in plans
    _check_bands(plans, h)


def test_fwd_plan_fills_the_card_and_is_cached():
    """K2's plan by the rule of K1's and K3's: 16 at 64²×8 where 8 clusters
    of 16 fit, else 8; 2 at batch 64; 1 at batch 132; capped at H rows; the
    smallest that fits at a large batch at 84² (2) and at 128² (8, in the
    large layout, where 4 does not fit); at 128²×8 as at 64²×8; one plan
    object per shape; no plan beyond shared memory."""
    def plan(batch, h, w, limit=_resident_clusters):
        return cuda_fluid.fwd_plan(batch, h, w, sm_count=132, max_clusters=limit)

    assert plan(8, 64, 64).cluster == 16
    assert plan(8, 64, 64, _no_resident_16).cluster == 8
    assert plan(64, 64, 64).cluster == 2
    assert plan(132, 64, 64).cluster == 1
    assert plan(1, 8, 8).cluster == 8
    assert plan(200, 84, 84).cluster == 2
    assert plan(8, 128, 128).cluster == 16
    assert plan(8, 128, 128, _no_resident_16).cluster == 8
    assert plan(200, 128, 128).cluster == 8
    assert plan(8, 64, 64) is plan(8, 64, 64)
    with pytest.raises(ValueError, match="shared memory"):
        plan(1, 8, 4096)


# Grids around the gates' edges: where K1 and the fused step take a grid,
# every batch has a plan of each kernel that runs there.
_GATE_SHAPES = [(8, 8), (24, 30), (32, 48), (64, 64), (84, 84), (85, 85),
                (96, 96), (98, 98), (99, 99), (112, 112), (64, 128),
                (128, 128), (136, 136), (154, 154), (256, 256), (362, 362)]


@pytest.mark.parametrize("h,w", _GATE_SHAPES,
                         ids=["x".join(map(str, s)) for s in _GATE_SHAPES])
def test_plans_exist_where_the_gates_say_yes(h, w):
    """Wherever `cuda_solve_fits` says yes, K1 has a plan at every batch;
    wherever `fused_step_fits` says yes, K2 and K3 do."""
    batches = (1, 2, 8, 64, 132, 1000)
    if cuda_cg.cuda_solve_fits(h, w):
        for b in batches:
            assert cuda_cg.solve_plan(b, h, w, sm_count=132,
                                      max_clusters=_resident_clusters)
    if cuda_fluid.fused_step_fits(h, w):
        for b in batches:
            assert cuda_fluid.fwd_plan(b, h, w, sm_count=132,
                                       max_clusters=_resident_clusters)
            assert cuda_fluid.bwd_plan(b, h, w, sm_count=132,
                                       max_clusters=_resident_clusters)
    assert cuda_cg.cuda_solve_fits(h, w)
    assert cuda_fluid.fused_step_fits(h, w) is cuda_fluid.pallas_fused_domain(
        h, w)


@pytest.mark.requires_cuda
def test_fused_kernels_reject_bad_inputs():
    dev = _cuda()
    domain = Domain2D.create(64, 64, obstacle_mask=_plate(64), device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    ops, cots = _fused_inputs(64, "cold-force", dev, batch=2)
    vy, vx, rho = ops.pop("vy"), ops.pop("vx"), ops.pop("rho")

    def fwd(*a, **k):
        return cuda_fluid.fused_step_forward(*a, *geom, **k, **_FUSED)

    with pytest.raises(ValueError, match="float32"):
        fwd(vy.double(), vx, rho)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(vy, vx, rho.transpose(1, 2))
    with pytest.raises(ValueError, match="shape"):
        fwd(vx, vy, rho)
    with pytest.raises(ValueError, match="go together"):
        fwd(vy, vx, rho, fy=ops["fy"])
    with pytest.raises(ValueError, match="shape"):
        cuda_fluid.fused_step_backward(vy, vx, rho, cots[1], cots[0], *cots[2:],
                                       *geom, has_force=True, has_inflow=False,
                                       **_FUSED)
    big = Domain2D.create(237, 237, device=dev)
    with pytest.raises(ValueError, match="fused gate"):
        cuda_fluid.fused_step_forward(
            torch.zeros(1, 238, 237, device=dev),
            torch.zeros(1, 237, 238, device=dev),
            torch.zeros(1, 237, 237, device=dev), big.acc_y, big.acc_x,
            big.fluid_mask, **_FUSED)


def test_fused_wrapper_takes_cpu_and_cuda_only():
    domain = Domain2D.create(8, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_fluid.fused_step_forward(
            torch.zeros(1, 9, 8, device="meta"),
            torch.zeros(1, 8, 9, device="meta"),
            torch.zeros(1, 8, 8, device="meta"), domain.acc_y, domain.acc_x,
            domain.fluid_mask, **_FUSED)


def test_fused_cpu_tensors_run_the_plain_version():
    domain = Domain2D.create(8, 8, obstacle_mask=_plate(8), device="cpu")
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    ops, cots = _fused_inputs(8, "warm-force-inflow", "cpu", batch=2)
    vy, vx, rho = ops.pop("vy"), ops.pop("vx"), ops.pop("rho")
    before = (cuda_fluid.LAUNCHES_FWD, cuda_fluid.LAUNCHES_BWD)
    out = cuda_fluid.fused_step_forward(vy, vx, rho, *geom, **ops, **_FUSED)
    ref = cuda_fluid.fused_step_plain_forward(vy, vx, rho, *geom, **ops,
                                              **_FUSED)
    g = cuda_fluid.fused_step_backward(vy, vx, rho, *cots, *geom,
                                       has_force=True, has_inflow=True,
                                       **_FUSED)
    g_ref = cuda_fluid.fused_step_plain_backward(vy, vx, rho, *cots, *geom,
                                                 has_force=True,
                                                 has_inflow=True, **_FUSED)
    assert (cuda_fluid.LAUNCHES_FWD, cuda_fluid.LAUNCHES_BWD) == before
    for a, b in zip(out + g, ref + g_ref):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- K4 / K5

# (batch, H, W, Cin, Cout): the main path's ragged channel counts (5 → 32,
# 32 → 1, 3 → 16), its widest layers, and a grid whose pixels leave the
# last tile part empty.
_MAIN_SHAPES = [(8, 64, 64, 5, 32), (8, 64, 64, 64, 64), (8, 64, 64, 32, 1),
                (64, 64, 64, 3, 16), (8, 8, 8, 128, 128), (16, 16, 16, 128, 64),
                (3, 7, 9, 16, 24)]
# What K5's runs of whole rows can get wrong: rows that the rows per run do
# not divide, one row, one column, W below a fragment's 16 pixels, Cin above
# the channel tile with one output channel, and blocks whose runs pass from
# one sample to the next. What K4's plan can get wrong: positions the tiles
# do not divide, one pixel, an image cut into segments of columns (W = 300
# with a 64-channel tile, forward and dX), Cin 3 and 5 (and 1 for dX), Cout
# 1, partial channel slices and Cout tiles, and splits of K.
_EDGE_SHAPES = [(2, 13, 64, 32, 32), (40, 13, 64, 32, 32), (4, 1, 16, 32, 16),
                (4, 16, 1, 16, 16), (8, 8, 8, 64, 128), (2, 16, 16, 128, 1),
                (5, 3, 64, 64, 64), (40, 5, 8, 128, 128),
                (1, 1, 1, 5, 1), (1, 3, 300, 16, 64), (1, 3, 300, 64, 16),
                (8, 12, 12, 3, 32), (4, 10, 10, 5, 32), (6, 11, 13, 32, 1),
                (3, 5, 6, 40, 72), (2, 4, 4, 128, 64), (2, 1, 64, 32, 32)]
_CONV_SHAPES = _MAIN_SHAPES + _EDGE_SHAPES


def _conv_inputs(b, h, w, cin, cout, dev, seed=0):
    """x, wflat, bias and a cotangent in bf16, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.tensor(scale * rng.normal(size=shape), dtype=torch.float32,
                            device=dev).to(torch.bfloat16)

    return (t(b, h, w, cin), t(9 * cin, cout, scale=1 / np.sqrt(9 * cin)),
            t(cout, scale=0.1), t(b, h, w, cout))


def _rel_max(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _conv_counts():
    return (cuda_conv.LAUNCHES_FWD, cuda_conv.LAUNCHES_DX, cuda_conv.LAUNCHES_DW)


@pytest.mark.parametrize("shape", _CONV_SHAPES,
                         ids=["x".join(map(str, s)) for s in _CONV_SHAPES])
@pytest.mark.requires_cuda
def test_conv_kernels_match_plain(shape):
    """y and dX within 1e-2 of the plain version's max|ref| (one bf16 ulp is
    2^-8 and the fp32 sums run in another order), dW within 2e-2 (it sums
    2^15..2^18 products), all three the same in every run; each launch
    counts once."""
    dev = _cuda()
    x, wflat, bias, g = _conv_inputs(*shape, dev)
    before = _conv_counts()
    y = cuda_conv.conv3x3_forward(x, wflat, bias)
    dx = cuda_conv.conv3x3_dx(g, wflat)
    dw = cuda_conv.conv3x3_dw(x, g)
    torch.cuda.synchronize()
    assert _conv_counts() == tuple(n + 1 for n in before)
    assert y.shape == g.shape and dx.shape == x.shape and dw.shape == wflat.shape
    assert _rel_max(y, cuda_conv.conv3x3_plain(x, wflat, bias)) <= 1e-2
    assert _rel_max(cuda_conv.conv3x3_forward(x, wflat),
                    cuda_conv.conv3x3_plain(x, wflat)) <= 1e-2
    assert _rel_max(dx, cuda_conv.conv3x3_plain(
        g, cuda_conv.rotate_weights(wflat))) <= 1e-2
    assert _rel_max(dw, cuda_conv.conv3x3_dw_plain(x, g)) <= 2e-2
    assert torch.equal(cuda_conv.conv3x3_forward(x, wflat, bias), y)
    assert torch.equal(cuda_conv.conv3x3_dx(g, wflat), dx)
    assert torch.equal(cuda_conv.conv3x3_dw(x, g), dw)


@pytest.mark.parametrize("needs_x", [True, False])
@pytest.mark.requires_cuda
def test_conv_autograd_matches_cpu(needs_x):
    """`conv3x3` on the card against the same call on the CPU (the plain
    versions): output and the gradients of x, kernel and bias within the
    limits above; no dX launch when x needs no gradient."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 32, 32, 32)).astype(np.float32)
    k = (rng.normal(size=(3, 3, 32, 16)) / np.sqrt(288)).astype(np.float32)
    b = (0.1 * rng.normal(size=16)).astype(np.float32)
    g = rng.normal(size=(4, 32, 32, 16)).astype(np.float32)
    out = {}
    for d in ("cpu", dev):
        xt = torch.tensor(x, device=d, requires_grad=needs_x)
        kt = torch.tensor(k, device=d, requires_grad=True)
        bt = torch.tensor(b, device=d, requires_grad=True)
        before = _conv_counts()
        y = cuda_conv.conv3x3(xt, kt, bt)
        y.backward(torch.tensor(g, device=d).to(torch.bfloat16))
        launched = tuple(a - n for a, n in zip(_conv_counts(), before))
        out[str(d)] = (y, xt.grad, kt.grad, bt.grad, launched)
    cpu, gpu = out["cpu"], out["cuda"]
    assert cpu[4] == (0, 0, 0) and gpu[4] == (1, int(needs_x), 1)
    assert _rel_max(gpu[0].cpu(), cpu[0]) <= 1e-2
    if needs_x:
        assert _rel_max(gpu[1].cpu(), cpu[1]) <= 1e-2
    else:
        assert gpu[1] is None and cpu[1] is None
    assert _rel_max(gpu[2].cpu(), cpu[2]) <= 2e-2
    assert _rel_max(gpu[3].cpu(), cpu[3]) <= 2e-2


@pytest.mark.requires_cuda
def test_conv_kernels_reject_bad_inputs():
    dev = _cuda()
    x, wflat, bias, g = _conv_inputs(2, 8, 8, 16, 16, dev)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_conv.conv3x3_forward(x.float(), wflat.float())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_conv.conv3x3_forward(x.transpose(1, 2), wflat)
    with pytest.raises(ValueError, match="shape"):
        cuda_conv.conv3x3_forward(x, wflat[:-1])
    with pytest.raises(ValueError, match="shape"):
        cuda_conv.conv3x3_forward(x, wflat, bias[:-1])
    with pytest.raises(ValueError, match="shape"):
        cuda_conv.conv3x3_dw(x, g[:, :-1])
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        cuda_conv.conv3x3_dx(g[0], wflat)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_conv.conv3x3(x.float(), torch.zeros(3, 3, 16, 4, device=dev),
                          dtype=torch.float32)


def test_conv_wrapper_takes_cpu_and_cuda_only():
    x = torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16, device="meta")
    w = torch.zeros(72, 8, dtype=torch.bfloat16, device="meta")
    for fn, args in ((cuda_conv.conv3x3_forward, (x, w)),
                     (cuda_conv.conv3x3_dx, (x, w)),
                     (cuda_conv.conv3x3_dw, (x, x))):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(*args)


def test_conv_cpu_tensors_run_the_plain_version():
    x, wflat, bias, g = _conv_inputs(2, 6, 5, 8, 3, "cpu")
    before = _conv_counts()
    got = (cuda_conv.conv3x3_forward(x, wflat, bias),
           cuda_conv.conv3x3_dx(g, wflat), cuda_conv.conv3x3_dw(x, g))
    want = (cuda_conv.conv3x3_plain(x, wflat, bias),
            cuda_conv.conv3x3_plain(g, cuda_conv.rotate_weights(wflat)),
            cuda_conv.conv3x3_dw_plain(x, g))
    assert _conv_counts() == before  # no kernel on the CPU
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# The main path's shape families (64²×8 and ×64, 32²×64, 16² and 8² with
# 128 channels) beside the shapes above.
_PLAN_SHAPES = _CONV_SHAPES + [(64, 64, 64, 32, 16), (64, 32, 32, 64, 32),
                               (64, 8, 8, 128, 128), (32, 16, 16, 64, 64),
                               (1, 1, 1, 5, 1)]


@pytest.mark.parametrize("shape", _PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in _PLAN_SHAPES])
def test_dw_splits_cover_the_pixels(shape):
    """K5's plan: every row of every sample in exactly one run of one block,
    no run crossing a sample, no block without a run, the shared memory
    within the card's limit, and the partials' bytes as the splits make
    them."""
    b, h, w, cin, cout = shape
    plan = cuda_conv.dw_plan(*shape)
    assert 1 <= plan.rows <= h and plan.runs_per_block >= 1
    assert 1 <= plan.splits <= 132  # one wave of blocks at most
    runs_per_sample = -(-h // plan.rows)
    total_runs = b * runs_per_sample
    assert (plan.splits - 1) * plan.runs_per_block < total_runs
    assert total_runs <= plan.splits * plan.runs_per_block
    seen = np.zeros((b, h), int)
    for split in range(plan.splits):  # the kernel's walk over its runs
        first = split * plan.runs_per_block
        for run in range(first, min(total_runs, first + plan.runs_per_block)):
            sample, r0 = divmod(run, runs_per_sample)
            r0 *= plan.rows
            assert r0 < h  # the run lies in its own sample
            seen[sample, r0:min(h, r0 + plan.rows)] += 1
    assert (seen == 1).all()
    assert plan.shared_bytes == cuda_conv.dw_shared_bytes(plan.rows, w, cin, cout)
    assert plan.shared_bytes <= cuda_conv.MAX_SHARED_BYTES == 232448
    assert plan.partial_bytes == (plan.splits * 9 * cin * cout * 4
                                  if plan.splits > 1 else 0)


def test_dw_plan_rejects_an_image_too_wide_for_one_row():
    with pytest.raises(ValueError, match="shared memory"):
        cuda_conv.dw_plan(1, 4, 4096, 64, 64)


def _fwd_coverage(b, h, w, cin, cout, plan):
    """How often the first pass's blocks (`conv3x3_fwd_kernel`'s index
    math) write each (split, pixel, output channel), and the slices each
    split sums."""
    wp = plan.seg + 1 if plan.seg >= w else plan.seg + 2
    bm = 128 * plan.fm
    tiles = -(-((b * (h + 1) - 1) * wp) // bm)
    strips, n_tiles = -(-w // plan.seg), -(-cout // plan.bn)
    q_end = b * (h + 1) * wp
    counts = np.zeros(b * h * w, int)
    for strip in range(strips):
        q = wp + np.arange(tiles * bm)
        q = q[q < q_end]
        row, pc = np.divmod(q, wp)
        sample, rr = np.divmod(row, h + 1)
        col = strip * plan.seg + pc - 1
        keep = (rr >= 1) & (pc >= 1) & (pc <= plan.seg) & (col < w)
        np.add.at(counts, ((sample * h + rr - 1) * w + col)[keep], 1)
    channels = np.zeros(cout, int)
    for tile in range(n_tiles):
        channels[tile * plan.bn:(tile + 1) * plan.bn] += 1
    slices = -(-cin // 16)
    per_split = -(-slices // plan.splits)
    runs = [range(z * per_split, min(slices, (z + 1) * per_split))
            for z in range(plan.splits)]
    return counts, channels, tiles * strips * n_tiles, runs


# K4's edge shapes of `chip_smoke.py` beside the shapes above.
_FWD_PLAN_SHAPES = _PLAN_SHAPES + [
    (2, 9, 700, 16, 64), (1, 3, 4096, 16, 16), (1, 4, 4096, 64, 64),
    (2, 1, 100000, 8, 8), (3, 5, 6, 40, 72), (2, 4, 4, 128, 64)]


@pytest.mark.parametrize("shape", _FWD_PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in _FWD_PLAN_SHAPES])
@pytest.mark.parametrize("direction", ["fwd", "dx"])
def test_fwd_plan_covers_the_output_once(shape, direction):
    """K4's plan, forward and for dX (dY's channels in, dX's out): every
    output pixel and channel written by exactly one block of each split,
    every slice of K in exactly one split and no split empty, a tile the
    kernel has, shared memory within a block's limit and two blocks'
    share of an SM, and the partials' bytes as the splits make them.
    No shape is refused, however wide (the kernel cuts it into segments)."""
    b, h, w, cin, cout = shape
    if direction == "dx":
        cin, cout = cout, cin
    plan = cuda_conv.fwd_plan(b, h, w, cin, cout)
    assert (plan.bn, plan.fm) in cuda_conv.FWD_TILES
    assert plan.bn == (16 if cout <= 16 else 32)
    assert 1 <= plan.seg <= w and 1 <= plan.splits <= -(-cin // 16)
    counts, channels, blocks, runs = _fwd_coverage(b, h, w, cin, cout, plan)
    assert (counts == 1).all() and (channels == 1).all()
    assert blocks == plan.blocks
    assert all(len(r) > 0 for r in runs)
    assert sorted(s for r in runs for s in r) == list(range(-(-cin // 16)))
    assert plan.shared_bytes == cuda_conv.fwd_shared_bytes(plan.bn, plan.fm,
                                                           plan.seg, w)
    assert plan.shared_bytes <= 233472 // 2 - 1024 < cuda_conv.MAX_SHARED_BYTES
    assert plan.partial_bytes == (plan.splits * 4 * b * h * w * cout
                                  if plan.splits > 1 else 0)


def test_fwd_plan_fills_the_card_and_is_cached():
    """The 128-channel layers at 8² and 16² (batch 8) split K until they
    have a block per SM; the 64² layers need no split; one plan object per
    shape."""
    for shape in ((8, 8, 8, 128, 128), (8, 16, 16, 128, 64)):
        plan = cuda_conv.fwd_plan(*shape)
        assert plan.splits > 1 and plan.blocks * plan.splits >= 66
    for shape in ((8, 64, 64, 64, 64), (64, 64, 64, 32, 16)):
        plan = cuda_conv.fwd_plan(*shape)
        assert plan.splits == 1 and plan.blocks >= 132
    assert cuda_conv.fwd_plan(8, 8, 8, 128, 128) is cuda_conv.fwd_plan(8, 8, 8,
                                                                       128, 128)


# ----------------------------------------------------------- progress_multi

# The three paths of the training step: the unfused step (its pressure
# solve on K1), the fused step (K2/K3) and the fused step with the nets'
# 3×3 stride-1 convs on K4/K5.
_PATHS = {"unfused": ("auto", "xla"), "fused": ("cuda", "xla"),
          "conv": ("cuda", "cuda")}


def _training_app(path: str, dev, n: int = 4, h: int = 32):
    """'refined' at h², n, batch 2 with clip and cosine schedule, bf16 nets,
    the CFE's output layer perturbed from a numpy seed."""
    from pde_control_tpu_torch import (
        ControlTraining,
        FluidConfig,
        IncompressibleFluidPDE,
    )

    fused, conv_impl = _PATHS[path]
    domain = Domain2D.create(h, h, obstacle_mask=_plate(h), device=dev)
    cfg = FluidConfig(dt=1.0, buoyancy=0.08, pressure_tol=1e-4,
                      pressure_maxiter=100, warm_start_pressure=True,
                      fused=fused)
    pde = IncompressibleFluidPDE(domain, cfg, control="buoyancy",
                                 unet_levels=2, cfe_features=(32, 64, 64, 32),
                                 dtype=torch.bfloat16, conv_impl=conv_impl)
    app = ControlTraining(n, pde, trainable_networks=("CFE", "OP4", "OP2"),
                          sequence_class="refined", grad_clip=1.0,
                          lr_schedule="cosine", decay_steps=100).prepare()
    w = app.nets["CFE"].Conv_4.weight
    with torch.no_grad():
        w.copy_(torch.tensor(0.05 * np.random.default_rng(3).normal(
            size=tuple(w.shape)), dtype=torch.float32))
    return app


def _training_batches(k: int, n: int = 4, h: int = 32, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"obs": rng.uniform(0, 1, size=(k, 2, n + 1, h, h, 1)).astype(np.float32),
            "vy0": np.zeros((k, 2, h + 1, h), np.float32),
            "vx0": np.zeros((k, 2, h, h + 1), np.float32)}


@pytest.mark.parametrize("path", list(_PATHS))
@pytest.mark.requires_cuda
def test_progress_multi_replays_equal_progress_calls(path):
    """Three graph replays from a given state against three eager
    `progress` calls from a copy of it, cuDNN deterministic: the counts and
    counters equal; parameters, moments and metrics the same bits on the
    fused and conv paths, whose kernels are deterministic; on the unfused
    path, whose shift sampler's backward adds with atomics, parameters
    within 1e-5 (1% of one step at lr 1e-3) and each moment buffer within
    1e-2 of its largest entry."""
    dev = _cuda()
    batches = _training_batches(3)
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    benchmark=False, allow_tf32=False):
        eager, graph = _training_app(path, dev), _training_app(path, dev)
        steps = [eager.progress({k: v[i] for k, v in batches.items()})
                 for i in range(3)]
        stacked = graph.progress_multi(batches)
    assert graph.step_count == eager.step_count == 3
    assert graph.graph_launches["K2"] == (0 if path == "unfused" else 4)
    assert (graph.graph_launches["K1"] > 0) == (path == "unfused")
    assert (graph.graph_launches["K5"] > 0) == (path == "conv")
    state = list(zip(eager._state(), graph._state()))
    assert int(graph.optimizer.count) == int(eager.optimizer.count) == 3
    for a, b in state[-2:]:
        assert torch.equal(a, b)
    if path == "unfused":
        for a, b in state[:-5]:
            assert float((a - b).abs().max()) <= 1e-5
        for a, b in state[-5:-3]:
            assert float((a - b).abs().max()) <= 1e-2 * float(a.abs().max())
        return
    for a, b in state:
        assert torch.equal(a, b)
    for key, v in stacked.items():
        assert torch.equal(v, torch.stack([m[key] for m in steps])), key


@pytest.mark.requires_cuda
def test_progress_multi_skips_a_nonfinite_batch():
    """A replay on a batch with a NaN leaves parameters, moments and the
    count as they were and advances both not-finite counters."""
    dev = _cuda()
    app = _training_app("conv", dev)
    app.progress_multi(_training_batches(2))
    before = [t.clone() for t in app._state()]
    bad = _training_batches(1, seed=1)
    bad["obs"][0, 0, -1, 5, 5, 0] = np.nan
    m = app.progress_multi(bad)
    assert not torch.isfinite(m["loss"]).any()
    assert int(m["notfinite_total"][0]) == 1 and int(m["notfinite_consec"][0]) == 1
    for a, b in zip(app._state()[:-2], before[:-2]):
        assert torch.equal(a, b)
    assert int(app.notfinite_total) == int(app.notfinite_consec) == 1
    m = app.progress_multi(_training_batches(1, seed=2))
    assert int(m["notfinite_consec"][0]) == 0 and int(app.optimizer.count) == 3
