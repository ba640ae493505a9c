"""The pressure solve (K1) beyond 128², where it runs the cluster core's
banded layout (`csrc/pcg_cluster.cuh`), against the JAX package's, through
the goldens that `scripts/make_cg_goldens_big.py` wrote:
`tests/goldens/pcg_256.npz` (256², batch 2, cold and warm) and
`tests/goldens/pcg_edges.npz` (the Pallas gate's edges, batch 1: 351²
warm and 362² cold), each `pde_control_tpu/ops/pallas_cg.py ::
pallas_pressure_solve(interpret=True)` on a closed box with the plate, tol
1e-6.

On the CPU the plain version, which the wrapper runs for CPU tensors, is
held to the goldens at `tests/test_torch_pcg128.py`'s limits: the pressure
within 5e-6 of its largest entry, each sample's trip count within 1 of the
JAX package's CG on the same system. On a machine with a GPU,

    python -m pytest tests/test_torch_pcg_big.py --noconftest -q

also holds the kernel to them under its plan and every plan its launcher
takes (the banded layout at each of these grids): the pressure within
1e-4 of the golden's largest entry, trips within 1. The gate: wherever
the Pallas kernel's VMEM gate admits a grid, warm or cold, K1 has a plan
for it. Only that test imports the JAX package, inside, and skips where it
cannot be imported (the card); this file imports no JAX at the top.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pde_control_tpu_torch.ops import cuda_cg

torch.set_num_threads(1)

GOLDENS = Path(__file__).resolve().parent / "goldens"
# file: {case: (side, batch, warm)}
CASES = {"pcg_256.npz": {"cold": (256, 2, False), "warm": (256, 2, True)},
         "pcg_edges.npz": {"351-warm": (351, 1, True),
                           "362-cold": (362, 1, False)}}


def _cases(dev):
    """Every golden case: (label, side, div, geometry, x0, settings, the
    golden's pressure, its trip counts)."""
    for name, cases in CASES.items():
        z = np.load(GOLDENS / name)
        kw = dict(json.loads(str(z["config"])), closed=True)
        for case, (side, _, warm) in cases.items():
            prefix = "" if name == "pcg_256.npz" else f"{case}/"

            def t(key, prefix=prefix, z=z):
                return torch.tensor(z[prefix + key].astype(np.float32),
                                    device=dev)

            geom = tuple(t(k) for k in ("acc_y", "acc_x", "fluid"))
            yield (f"{name} {case}", side, t("div"), geom,
                   t("x0") if warm else None, kw, z[f"{case}/p"],
                   z[f"{case}/trips"])


def _within_scale(got, want, limit, label):
    got = got.detach().cpu().numpy()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= limit * scale, f"{label}: {err / scale:.3e} > {limit:g}"


def test_goldens_are_small_and_whole():
    """Each file at most 2 MB; the plate in a closed box of the case's
    side; float16-exact inputs; finite float32 pressures; trip counts that
    stopped by the tolerance, not by maxiter; and the banded layout at
    every case's grid."""
    for name, cases in CASES.items():
        assert (GOLDENS / name).stat().st_size <= 2 * 2 ** 20, name
        z = np.load(GOLDENS / name)
        cfg = json.loads(str(z["config"]))
        assert cfg["tol"] == 1e-6
        for case, (side, batch, warm) in cases.items():
            prefix = "" if name == "pcg_256.npz" else f"{case}/"
            fluid = z[prefix + "fluid"]
            assert fluid.shape == (side, side)
            assert fluid[side // 2, side // 4:side // 2].sum() == 0
            assert fluid.sum() == side * side - (side // 2 - side // 4)
            assert z[prefix + "acc_y"][0].sum() == 0  # walls
            assert z[prefix + "div"].dtype == np.float16
            assert z[prefix + "div"].shape == (batch, side, side)
            assert (prefix + "x0" in z) is (warm or not prefix)
            p, trips = z[f"{case}/p"], z[f"{case}/trips"]
            assert p.dtype == np.float32 and p.shape == (batch, side, side)
            assert np.isfinite(p).all()
            assert (trips > 0).all() and (trips < cfg["maxiter"]).all()
            assert cuda_cg.layout(side, side) == cuda_cg.BANDED


def test_plain_solve_matches_goldens():
    """`pcg_plain` (K1's plain version, which the wrapper runs for CPU
    tensors) against the JAX package's solve at 256², 351² warm and 362²
    cold."""
    for label, _, div, geom, x0, kw, want, trips in _cases("cpu"):
        before = cuda_cg.LAUNCHES
        p, iters = cuda_cg.pressure_solve(div, *geom, x0, **kw)
        assert cuda_cg.LAUNCHES == before
        _within_scale(p, want, 5e-6, label)
        assert int(np.abs(iters.numpy() - trips).max()) <= 1, label


@pytest.mark.requires_cuda
def test_kernel_matches_goldens():
    """K1 on the card, in the banded layout under its plan and every plan
    its launcher takes (C = 8 and 16 at 256², 16 at 351² and 362²),
    against the JAX package's solve; each launch counts once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    for label, side, div, geom, x0, kw, want, trips in _cases(dev):
        plans = cuda_cg.solve_plans(side, side)
        assert [p.cluster for p in plans] == ([8, 16] if side == 256 else [16])
        for plan in [None] + plans:
            before = cuda_cg.LAUNCHES
            p, iters = cuda_cg._launch_solve(div, *geom, x0, plan,
                                             precond=True, **kw)
            torch.cuda.synchronize()
            assert cuda_cg.LAUNCHES == before + 1
            _within_scale(p, want, 1e-4, f"{label} {plan}")
            assert int(np.abs(iters.cpu().numpy() - trips).max()) <= 1, (
                label, plan)


def test_layouts_by_side():
    """The layout rule on squares: small to 111², large from 112² to 153²,
    banded from 154² (where the large layout fits no cluster size); the
    banded layout's bytes at 256² (C = 8: the reduction area, then (5R +
    4)·W floats of bands and halo rows and 8·512 of the products' slices)
    and the cluster sizes it leaves (8 and 16 to 288², 16 alone above)."""
    sides = {cuda_cg.SMALL: (8, 64, 111), cuda_cg.LARGE: (112, 128, 153),
             cuda_cg.BANDED: (154, 256, 288, 289, 351, 362)}
    for want, ns in sides.items():
        for n in ns:
            assert cuda_cg.layout(n, n) == want, n
    assert cuda_cg.solve_shared_bytes(256, 256, 8, 512) == 4 * (
        192 + (5 * 32 + 4) * 256 + 8 * 512) == 185_088
    assert [p.cluster for p in cuda_cg.solve_plans(288, 288)] == [8, 16]
    assert [p.cluster for p in cuda_cg.solve_plans(289, 289)] == [16]
    assert cuda_cg.layout(96, 320) == cuda_cg.layout(320, 96) == cuda_cg.BANDED
    assert cuda_cg.layout(8, 1000) == cuda_cg.LARGE  # two whole rows of 8


def test_fits_wherever_the_pallas_gate_admits():
    """`cuda_solve_fits(h, w)` is true for every (H, W) that the JAX
    package's `pallas_solve_fits` admits, warm or cold: a sweep of sides,
    and each row's and column's last admitted grid."""
    pallas_cg = pytest.importorskip("pde_control_tpu.ops.pallas_cg")
    pallas_solve_fits = pallas_cg.pallas_solve_fits

    def admitted(h, w):
        return pallas_solve_fits(1, h, w, True) or pallas_solve_fits(1, h, w,
                                                                     False)

    grids = [(h, w) for h in range(1, 720, 7) for w in range(1, 1030, 9)]
    for h in range(1, 720, 3):  # the widest admitted grid of each height
        w = max((w for w in range(1, 1030) if admitted(h, w)), default=None)
        grids += [(h, w), (w, h)] if w else []
    grids += [(351, 351), (362, 362), (8, 997), (8, 999), (96, 320), (320, 96)]
    seen = 0
    for h, w in grids:
        if admitted(h, w):
            seen += 1
            assert cuda_cg.cuda_solve_fits(h, w), (h, w)
    assert seen > 5000
    assert not admitted(363, 363) and not admitted(8, 1000)
