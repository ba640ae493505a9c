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
