"""The port's CUDA kernels against their plain torch versions, on the card:
the pressure solve (K1, `ops/cuda_cg.py`) and the fused fluid step's
forward and backward (K2 and K3, `ops/cuda_fluid.py`).

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
from pde_control_tpu_torch.ops import cuda_cg, cuda_fluid
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


@pytest.mark.parametrize("h,w", [(64, 64), (32, 48)])
def test_shared_memory_count_matches_source(h, w):
    """The Python gate counts the bytes the kernel's source asks for."""
    import ctypes

    from pde_control_tpu_torch.ops import _build

    _cuda()
    fn = _build.load()[0].pcg_shared_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_size_t
    assert fn(h, w) == cuda_cg.shared_bytes(h, w)


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
    big = Domain2D.create(128, 128, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_cg.pressure_solve(torch.zeros(1, 128, 128, device=dev), big.acc_y,
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
                                      (32, 48, True), (64, 128, False),
                                      (128, 128, False)])
def test_solve_fits_gate(h, w, fits):
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


def _fused_inputs(n, case, dev, batch=8, seed=0):
    """The step's operands and the four cotangents, from a numpy seed."""
    warm, force, inflow, zero_v, nonfinite = _FUSED_CASES[case]
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, uniform=False):
        a = rng.uniform(0, 1, shape) if uniform else rng.normal(size=shape)
        return torch.tensor(scale * a, dtype=torch.float32, device=dev)

    v = 0.0 if zero_v else 0.5
    ops = dict(vy=t(batch, n + 1, n, scale=v), vx=t(batch, n, n + 1, scale=v),
               rho=t(batch, n, n, uniform=True))
    if nonfinite:
        ops["vy"][0, n // 2, n // 3] = float("nan")
        ops["vx"][1, n // 3, n // 2] = float("inf")
    if force:
        ops.update(fy=t(batch, n + 1, n, scale=0.05),
                   fx=t(batch, n, n + 1, scale=0.05))
    if inflow:
        ops["inflow"] = t(batch, n, n, scale=0.05, uniform=True)
    if warm:
        ops["x0"] = t(batch, n, n, scale=0.5)
    cots = [t(batch, n + 1, n), t(batch, n, n + 1), t(batch, n, n),
            t(batch, n, n)]
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


@pytest.mark.parametrize("n", [64, 32])
@pytest.mark.parametrize("case", list(_FUSED_CASES))
def test_fused_kernels_match_plain(n, case):
    """K2's outputs within 1e-4 of the plain version's scale and its trip
    counts within 3; K3's cotangents within 1e-3; non-finite cells where
    the plain version has them. Each launch counts once."""
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


@pytest.mark.parametrize("h,w", [(64, 64), (32, 48)])
def test_fused_shared_memory_count_matches_source(h, w):
    import ctypes

    from pde_control_tpu_torch.ops import _build

    _cuda()
    fn = _build.load()[0].fused_shared_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_size_t
    assert fn(h, w) == cuda_fluid.shared_bytes(h, w)


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
    big = Domain2D.create(128, 128, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_fluid.fused_step_forward(
            torch.zeros(1, 129, 128, device=dev),
            torch.zeros(1, 128, 129, device=dev),
            torch.zeros(1, 128, 128, device=dev), big.acc_y, big.acc_x,
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
