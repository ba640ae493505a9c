"""The pressure solve (K1) at 128², the grid of the `smoke_128` entries,
against the JAX package's, through the golden that
`scripts/make_cg_goldens_128.py` wrote (`tests/goldens/pcg_128.npz`:
`pde_control_tpu/ops/pallas_cg.py :: pallas_pressure_solve
(interpret=True)` on a closed 128² box with a plate, batch 2, cold and
warm, tol 1e-6 / maxiter 200).

This file imports neither JAX nor the JAX package. On the CPU it holds the
plain version to the golden: the pressure within 5e-6 of its largest entry
(fp32 CG to tol 1e-6, sums in another order; the goldens of
`tests/test_torch_goldens.py` take the same limit) and each sample's trip
count within 1 of the JAX package's CG on the same system. On a machine
with a GPU,

    python -m pytest tests/test_torch_pcg128.py --noconftest -q

also holds the kernel to it under its plan and every plan its launcher
takes at 128² (all in the core's large layout): the pressure within 1e-4
of the golden's largest entry, trips within 1.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pde_control_tpu_torch.ops import cuda_cg

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "goldens" / "pcg_128.npz"
CASES = {"cold": False, "warm": True}


def _case(case: str, dev):
    """The golden's operands, settings, pressure and trip counts."""
    z = np.load(GOLDEN)

    def t(key):
        return torch.tensor(z[key].astype(np.float32), device=dev)

    geom = tuple(t(k) for k in ("acc_y", "acc_x", "fluid"))
    kw = dict(json.loads(str(z["config"])), closed=True)
    x0 = t("x0") if CASES[case] else None
    return t("div"), geom, x0, kw, z[f"{case}/p"], z[f"{case}/trips"]


def _within_scale(got, want, limit, label):
    got = got.detach().cpu().numpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= limit * scale, label


def test_golden_is_small_and_whole():
    """At most 1 MB; the plate in a closed 128² box; finite pressures and
    trip counts that stopped by the tolerance, not by maxiter."""
    assert GOLDEN.stat().st_size <= 2 ** 20
    z = np.load(GOLDEN)
    fluid = z["fluid"]
    assert fluid.shape == (128, 128) and fluid[64, 32:64].sum() == 0
    assert fluid.sum() == 128 * 128 - 32
    assert z["acc_y"][0].sum() == 0 and z["acc_x"][:, 0].sum() == 0  # walls
    cfg = json.loads(str(z["config"]))
    assert cfg["maxiter"] == 200
    for case in CASES:
        p, trips = z[f"{case}/p"], z[f"{case}/trips"]
        assert p.dtype == np.float32 and p.shape == z["div"].shape == (2, 128, 128)
        assert np.isfinite(p).all()
        assert (trips > 0).all() and (trips < cfg["maxiter"]).all()


@pytest.mark.parametrize("case", CASES)
def test_plain_solve_matches_golden(case):
    """`pcg_plain` (K1's plain version, which the wrapper runs for CPU
    tensors) against the JAX package's solve at 128²."""
    div, geom, x0, kw, want, trips = _case(case, "cpu")
    before = cuda_cg.LAUNCHES
    p, iters = cuda_cg.pressure_solve(div, *geom, x0, **kw)
    assert cuda_cg.LAUNCHES == before
    _within_scale(p, want, 5e-6, case)
    assert int(np.abs(iters.numpy() - trips).max()) <= 1


@pytest.mark.parametrize("case", CASES)
@pytest.mark.requires_cuda
def test_kernel_matches_golden(case):
    """K1 on the card, under its plan and every plan its launcher takes at
    128², against the JAX package's solve; each launch counts once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    div, geom, x0, kw, want, trips = _case(case, dev)
    plans = cuda_cg.solve_plans(128, 128)
    assert cuda_cg.layout(128, 128) == cuda_cg.LARGE
    assert {p.cluster for p in plans} == {4, 8, 16}
    for plan in [None] + plans:
        before = cuda_cg.LAUNCHES
        p, iters = cuda_cg._launch_solve(div, *geom, x0, plan, precond=True,
                                         **kw)
        torch.cuda.synchronize()
        assert cuda_cg.LAUNCHES == before + 1
        _within_scale(p, want, 1e-4, f"{case} {plan}")
        assert int(np.abs(iters.cpu().numpy() - trips).max()) <= 1, plan
