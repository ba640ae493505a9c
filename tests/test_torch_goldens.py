"""The fused fluid step (K2 forward, K3 backward) against the JAX package's,
through the goldens that `scripts/make_fused_goldens.py` wrote from
`pde_control_tpu/ops/pallas_fluid.py :: fused_fluid_step(interpret=True)`
and its VJP (32×32 closed box with the plate, batch 2, tol 1e-7 /
maxiter 500; a warm start with force and inflow, and zero velocity).

This file imports neither JAX nor the JAX package. On the CPU it holds the
plain versions to the goldens with the tolerances of
`tests/test_torch_cuda_fluid.py` (forward atol 5e-6 / rtol 1e-5, the VJP
3e-5 of each cotangent's largest entry). On a machine with a GPU:

    python -m pytest tests/test_torch_goldens.py --noconftest -q

also holds the kernels to them: outputs within 1e-4 and cotangents within
1e-3 of the golden's largest entry (fp32 sums in another order), K3 under
`bwd_plan`'s plan and under every plan its launcher takes.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pde_control_tpu_torch.ops import cuda_fluid

torch.set_num_threads(1)

GOLDENS = Path(__file__).resolve().parent / "goldens" / "fused_step_32.npz"
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
def test_kernels_match_goldens(case):
    """K2, and K3 under every plan, on the card against the JAX package."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    state, ops, geom, cots, cfg, outs, grads = _case(case, dev)
    out = cuda_fluid.fused_step_forward(*state, *geom, **ops, **cfg)
    for name, got, want in zip(OUTS, out, outs):
        _within_scale(got, want, 1e-4, name)
    for plan in [None] + cuda_fluid.bwd_plans(32, 32):
        got = cuda_fluid._launch_backward(*state, *cots, *geom, plan,
                                          has_force=True,
                                          has_inflow=ops["inflow"] is not None,
                                          **cfg)
        for name, a, want in zip(GRADS, got, grads):
            assert (a is None) == (want is None), (name, plan)
            if a is not None:
                _within_scale(a, want, 1e-3, f"{name} {plan}")
