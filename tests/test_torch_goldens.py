"""The fused fluid step (K2 forward, K3 backward), the pressure solve
(K1) and the 3×3 conv (K4 forward and dX, K5 dW) against the JAX
package's, through goldens:
`scripts/make_fused_goldens.py` wrote `tests/goldens/fused_step_32.npz`
from `pde_control_tpu/ops/pallas_fluid.py :: fused_fluid_step
(interpret=True)` and its VJP (32×32 closed box with the plate, batch 2,
tol 1e-7 / maxiter 500; a warm start with force and inflow, and zero
velocity); `scripts/make_cg_goldens.py` wrote `tests/goldens/pcg_32.npz`
from `pde_control_tpu/ops/pallas_cg.py :: pallas_pressure_solve
(interpret=True)` (the same box closed, cold and warm, and open, cold);
`scripts/make_conv_goldens.py` wrote `tests/goldens/conv3x3_32.npz` from
`pde_control_tpu/ops/pallas_conv.py :: conv3x3(bfloat16, interpret=True)`
and its VJP (32², batch 2, with a bias: 5 → 32, 64 → 64, 16 → 16, 32 → 16),
and `tests/goldens/conv3x3_32_wide.npz` the same at the indirect-smoke
task's CFE widths (6 → 48, 48 → 96, 96 → 96, 96 → 48).

This file imports neither JAX nor the JAX package. On the CPU it holds the
plain versions to the goldens with the tolerances of
`tests/test_torch_cuda_fluid.py` (forward atol 5e-6 / rtol 1e-5, the VJP
3e-5 of each cotangent's largest entry) and, for the solve, 5e-6 of the
pressure's largest entry (fp32 CG to tol 1e-7, sums in another order);
the conv's y, dX, dW and db, in bf16, to 1e-2 of each one's largest entry
(one bf16 ulp is 2⁻⁸; the fp32 sums run in another order), on the CPU and
on the card. On a machine with a GPU:

    python -m pytest tests/test_torch_goldens.py --noconftest -q

also holds the kernels to them: outputs within 1e-4 and cotangents within
1e-3 of the golden's largest entry (fp32 sums in another order), K1, K2
and K3 under their plan and under every plan their launchers take (K4 and
K5 likewise, at the conv's limit); and K3's cold solve to the bits it
gave before K1 and K2 moved onto its core.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pde_control_tpu_torch.ops import cuda_cg, cuda_conv, cuda_fluid

torch.set_num_threads(1)

GOLDENS = Path(__file__).resolve().parent / "goldens" / "fused_step_32.npz"
CG_GOLDENS = GOLDENS.with_name("pcg_32.npz")
# (closed, warm) per case of the solve's goldens.
CG_CASES = {"closed-cold": (True, False), "closed-warm": (True, True),
            "open-cold": (False, False)}
CASES = ("warm-force-inflow", "zero-velocity")
OUTS = ("vy4", "vx4", "rho1", "p")
GRADS = ("vy", "vx", "rho", "fy", "fx", "inflow")


def _case(case: str, dev):
    """The golden's step operands, output cotangents, settings, outputs
    and input cotangents (None where the case has no such operand)."""
    z = np.load(GOLDENS)

    def t(key):
        return torch.tensor(z[key].astype(np.float32), device=dev)

    zero_v = case == "zero-velocity"
    cfg = json.loads(str(z["config"]))
    state = tuple(torch.zeros_like(t(k)) if zero_v else t(k) for k in ("vy", "vx")
                  ) + (t("rho"),)
    ops = dict(fy=t("fy"), fx=t("fx"), inflow=None if zero_v else t("inflow"),
               x0=None if zero_v else t("x0"))
    geom = tuple(t(k) for k in ("acc_y", "acc_x", "fluid"))
    cots = [t(k) for k in ("g_vy4", "g_vx4", "g_rho1", "g_p")]
    outs = [z[f"{case}/{n}"] for n in OUTS]
    grads = [None if zero_v and n == "inflow" else z[f"{case}/d_{n}"]
             for n in GRADS]
    return state, ops, geom, cots, cfg, outs, grads


def _k3_digests(dev) -> dict:
    """SHA-256 (first 16 hex digits) of K3's cotangents and trip counts on
    the goldens' operands of each case, under every plan at 32²."""
    import hashlib

    out = {}
    for case in CASES:
        state, ops, geom, cots, cfg, _, _ = _case(case, dev)
        for plan in cuda_fluid.bwd_plans(32, 32):
            got = cuda_fluid._launch_backward(
                *state, *cots, *geom, plan, has_force=True,
                has_inflow=ops["inflow"] is not None, **cfg)
            digest = hashlib.sha256()
            for a in got:
                if a is not None:
                    digest.update(a.cpu().numpy().tobytes())
            out[f"{case} C{plan.cluster}"] = digest.hexdigest()[:16]
    return out


def _within_scale(got, want, limit, label):
    got = got.detach().cpu().numpy()
    scale = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=limit,
                               err_msg=label)


@pytest.mark.parametrize("case", CASES)
def test_plain_fused_step_matches_goldens(case):
    """The plain K2 and K3 on CPU tensors against the JAX package's step
    and VJP."""
    state, ops, geom, cots, cfg, outs, grads = _case(case, "cpu")
    out = cuda_fluid.fused_step_forward(*state, *geom, **ops, **cfg)
    for name, got, want in zip(OUTS, out, outs):
        np.testing.assert_allclose(got.numpy(), want, atol=5e-6, rtol=1e-5,
                                   err_msg=name)
    got = cuda_fluid.fused_step_backward(*state, *cots, *geom, has_force=True,
                                         has_inflow=ops["inflow"] is not None,
                                         **cfg)
    for name, a, want in zip(GRADS, got, grads):
        assert (a is None) == (want is None), name
        if a is not None:
            _within_scale(a, want, 3e-5, name)


def test_goldens_are_small_and_whole():
    """The file stays small, holds every array the tests read, and its
    geometry is the plate's."""
    assert GOLDENS.stat().st_size <= 200 * 1024
    z = np.load(GOLDENS)
    fluid = z["fluid"]
    assert fluid.shape == (32, 32) and fluid[16, 8:16].sum() == 0
    assert fluid.sum() == 32 * 32 - 8
    for case in CASES:
        for n in OUTS:
            assert z[f"{case}/{n}"].dtype == np.float32
            assert np.isfinite(z[f"{case}/{n}"]).all()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.requires_cuda
def test_kernels_match_goldens(case):
    """K2 and K3, each under its plan and every plan its launcher takes, on
    the card against the JAX package."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    state, ops, geom, cots, cfg, outs, grads = _case(case, dev)
    for plan in [None] + cuda_fluid.fwd_plans(32, 32):
        out = cuda_fluid._launch_forward(*state, *geom, ops["fy"], ops["fx"],
                                         ops["inflow"], ops["x0"], plan, **cfg)
        for name, got, want in zip(OUTS, out, outs):
            _within_scale(got, want, 1e-4, f"{name} {plan}")
    for plan in [None] + cuda_fluid.bwd_plans(32, 32):
        got = cuda_fluid._launch_backward(*state, *cots, *geom, plan,
                                          has_force=True,
                                          has_inflow=ops["inflow"] is not None,
                                          **cfg)
        for name, a, want in zip(GRADS, got, grads):
            assert (a is None) == (want is None), (name, plan)
            if a is not None:
                _within_scale(a, want, 1e-3, f"{name} {plan}")


def _cg_case(case: str, dev):
    """The solve goldens' operands, settings and pressure for `case`."""
    z = np.load(CG_GOLDENS)
    closed, warm = CG_CASES[case]
    box = "closed" if closed else "open"

    def t(key):
        return torch.tensor(z[key].astype(np.float32), device=dev)

    geom = tuple(t(f"{box}/{k}") for k in ("acc_y", "acc_x", "fluid"))
    kw = dict(json.loads(str(z["config"])), closed=closed)
    return t("div"), geom, t("x0") if warm else None, kw, z[f"{case}/p"]


@pytest.mark.parametrize("case", CG_CASES)
def test_plain_solve_matches_goldens(case):
    """The plain K1 on CPU tensors against the JAX package's solve."""
    div, geom, x0, kw, want = _cg_case(case, "cpu")
    p, iters = cuda_cg.pressure_solve(div, *geom, x0, **kw)
    _within_scale(p, want, 5e-6, case)
    assert (iters > 0).all() and (iters < kw["maxiter"]).all()


def test_cg_goldens_are_small_and_whole():
    """The solve's goldens stay small, hold every array the tests read,
    and their geometry is the plate's in a closed and an open box."""
    assert CG_GOLDENS.stat().st_size <= 64 * 1024
    z = np.load(CG_GOLDENS)
    for box in ("closed", "open"):
        fluid = z[f"{box}/fluid"]
        assert fluid.shape == (32, 32) and fluid[16, 8:16].sum() == 0
        assert fluid.sum() == 32 * 32 - 8
    assert not np.array_equal(z["closed/acc_y"], z["open/acc_y"])
    for case in CG_CASES:
        p = z[f"{case}/p"]
        assert p.dtype == np.float32 and p.shape == z["div"].shape
        assert np.isfinite(p).all()


@pytest.mark.parametrize("case", CG_CASES)
@pytest.mark.requires_cuda
def test_solve_kernel_matches_goldens(case):
    """K1 on the card, under its plan and every plan its launcher takes,
    against the JAX package's solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    div, geom, x0, kw, want = _cg_case(case, dev)
    for plan in [None] + cuda_cg.solve_plans(32, 32):
        p, _ = cuda_cg._launch_solve(div, *geom, x0, plan, precond=True, **kw)
        _within_scale(p, want, 1e-4, f"{case} {plan}")


CONV_GOLDENS = GOLDENS.with_name("conv3x3_32.npz")
CONV_GOLDENS_WIDE = GOLDENS.with_name("conv3x3_32_wide.npz")
# The goldens' file of each case: the main path's widths, and the
# indirect-smoke task's CFE widths.
CONV_FILES = {**dict.fromkeys(("5-32", "64-64", "16-16", "32-16"),
                              CONV_GOLDENS),
              **dict.fromkeys(("6-48", "48-96", "96-96", "96-48"),
                              CONV_GOLDENS_WIDE)}
CONV_CASES = tuple(CONV_FILES)
CONV_OUTS = ("y", "dx", "dw", "db")


def _conv_case(case: str, dev):
    """The conv goldens' operands x, kernel, bias and cotangent as bf16
    tensors on `dev`, and the JAX package's y, dX, dW and db in fp32."""
    z = np.load(CONV_FILES[case])
    ops = [torch.tensor(z[f"{case}/{n}"].astype(np.float32), device=dev
                        ).to(torch.bfloat16) for n in "xkbg"]
    want = [torch.from_numpy(z[f"{case}/{n}"].view(np.int16)).view(
        torch.bfloat16).float().numpy() for n in CONV_OUTS]
    return ops, want


@pytest.mark.parametrize("case", CONV_CASES)
def test_plain_conv_matches_goldens(case):
    """`cuda_conv.conv3x3` on CPU tensors (K4's and K5's plain versions,
    through the autograd function) against the JAX package's bf16 conv."""
    (x, k, b, g), want = _conv_case(case, "cpu")
    x, k, b = (t.requires_grad_(True) for t in (x, k, b))
    y = cuda_conv.conv3x3(x, k, b)
    y.backward(g)
    for name, got, ref in zip(CONV_OUTS, (y, x.grad, k.grad, b.grad), want):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape, name
        _within_scale(got.float(), ref, 1e-2, name)


def test_conv_goldens_are_small_and_whole():
    """The conv's goldens stay under 1.5 MB (the main path's widths) and
    3.5 MB (the wide ones) and hold every array the tests read, each
    case's at its shapes."""
    assert CONV_GOLDENS.stat().st_size <= 1536 * 1024
    assert CONV_GOLDENS_WIDE.stat().st_size <= 3584 * 1024
    for case in CONV_CASES:
        z = np.load(CONV_FILES[case])
        cin, cout = map(int, case.split("-"))
        shapes = dict(x=(2, 32, 32, cin), k=(3, 3, cin, cout), b=(cout,),
                      g=(2, 32, 32, cout), y=(2, 32, 32, cout),
                      dx=(2, 32, 32, cin), dw=(3, 3, cin, cout), db=(cout,))
        for name, shape in shapes.items():
            a = z[f"{case}/{name}"]
            assert a.shape == shape, (case, name)
            assert a.dtype == (np.float16 if name in "xkbg" else np.uint16)
    _, want = _conv_case("64-64", "cpu")
    assert all(np.isfinite(a).all() and np.abs(a).max() > 0 for a in want)


def _conv_golden_plans(case: str):
    """Every (direction, plan) the conv kernels' launchers take at a golden
    case: K4 forward and dX under `fwd_plans` and K5 under `dw_plans`,
    each beside None, the wrappers' own plan."""
    cin, cout = map(int, case.split("-"))
    return ([("y", p) for p in [None] + cuda_conv.fwd_plans(2, 32, 32, cin, cout)]
            + [("dx", p) for p in [None] + cuda_conv.fwd_plans(2, 32, 32, cout,
                                                                 cin)]
            + [("dw", p) for p in [None] + cuda_conv.dw_plans(2, 32, 32, cin,
                                                               cout)])


def _run_conv_plan(ops, direction: str, plan):
    """K4 (y, dX) or K5 (dW, reshaped to the kernel's shape) on the golden
    operands under `plan`."""
    x, k, b, g = ops
    cin, cout = k.shape[2], k.shape[3]
    wflat = k.reshape(9 * cin, cout)
    if direction == "y":
        return cuda_conv._fwd_launch("forward", x, wflat, b, cin, cout, False,
                                     plan)
    if direction == "dx":
        return cuda_conv._fwd_launch("dX", g, wflat, None, cout, cin, True, plan)
    dw = cuda_conv._dw_launch(x, g, plan or cuda_conv.dw_plan(*x.shape, cout))
    return dw.reshape(k.shape)


@pytest.mark.parametrize("case", CONV_CASES)
@pytest.mark.requires_cuda
def test_conv_kernels_match_goldens(case):
    """K4 (forward and dX) and K5 on the card, under their wrappers' plan
    and every plan their launchers take, against the JAX package's conv."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ops, want = _conv_case(case, torch.device("cuda"))
    ref = dict(zip(CONV_OUTS, want))
    for direction, plan in _conv_golden_plans(case):
        got = _run_conv_plan(ops, direction, plan)
        _within_scale(got.float(), ref[direction], 1e-2, f"{direction} {plan}")


# K3's cotangents and trip counts on the fused goldens' operands, as
# `_k3_digests` hashes them, from the kernel before the cluster core took
# the warm start (NVIDIA H100 80GB HBM3).
K3_DIGESTS = {
    "warm-force-inflow C1": "6b7b1d14547b6168",
    "warm-force-inflow C2": "d49ecec80dfd7ab3",
    "warm-force-inflow C4": "74d1cd2e9537699b",
    "warm-force-inflow C8": "11cfd06a9aa98cac",
    "warm-force-inflow C16": "c602a0fceaeeda34",
    "zero-velocity C1": "aea80461023e6142",
    "zero-velocity C2": "924a9a54deac2c15",
    "zero-velocity C4": "5f27f85c9372b282",
    "zero-velocity C8": "2979bc0e3a7755d4",
    "zero-velocity C16": "5a1ad77172681b95",
}


@pytest.mark.requires_cuda
def test_k3_cold_solve_keeps_its_bits():
    """The cold path of the cluster CG core computes what it computed
    before the warm start and the unpreconditioned path joined it: K3 gives
    the same bits under every plan."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    assert _k3_digests(torch.device("cuda")) == K3_DIGESTS
