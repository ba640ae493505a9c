"""The port's CUDA kernels against their plain torch versions, on the card.

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
from pde_control_tpu_torch.ops import cuda_cg
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
    domain = Domain2D.create(8, 8, obstacle_mask=_plate(8))
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
