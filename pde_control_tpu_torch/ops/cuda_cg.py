"""Fused, spectrally preconditioned CG pressure solve: the Hopper kernel
(`csrc/pcg.cu`) and its plain PyTorch version.

Replaces the TPU kernel `pde_control_tpu/ops/pallas_cg.py ::
pallas_pressure_solve` (body `_pcg_kernel` → `pcg_core`). One thread block
solves one sample's masked pressure-Poisson system and runs the whole CG
loop on the card, with every iterate in shared memory; the source's header
gives the layout.

What bounds it on this card: latency, not bytes or FLOPs. A batch of B
samples occupies B of the H100's 132 SMs, and each iteration is a chain of
about ten block-wide barriers around four small fp32 basis products. The
design answers with no host round trip and no launch per iteration (the
loop and its per-sample exit live in the block) and with a lean
shared-memory layout; splitting a sample across a thread-block cluster or
packing samples per block are left for later.

`pressure_solve` launches the kernel for CUDA tensors and runs `pcg_plain`,
a transcription of `pcg_core` in torch, for CPU tensors; a CUDA tensor it
cannot take (dtype, shape, layout, a grid whose state does not fit in one
block's shared memory) raises. `LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pde_control_tpu_torch.ops.spectral import (
    _dct_matrix,
    _dst_matrix,
    _inv_dirichlet_eigenvalues,
    _inv_neumann_eigenvalues,
)

#: Number of kernel launches since import (or since a caller reset it).
LAUNCHES = 0

# Shared memory one H100 block may use (opt-in above 48 KB).
SMEM_LIMIT_BYTES = 232_448
_THREADS = 512


def shared_bytes(h: int, w: int) -> int:
    """Shared memory one block needs: five (H, W) fields, the basis (one
    copy when H == W, rows padded by one) and the reduction slots — the
    count `pcg_shared_bytes` makes in C."""
    floats = 5 * h * w + h * (h + 1) + (0 if h == w else w * (w + 1))
    return 4 * (floats + 4 * (_THREADS // 32))


def cuda_solve_fits(h: int, w: int) -> bool:
    """Whether one sample's CG state fits in a block's shared memory."""
    return shared_bytes(h, w) <= SMEM_LIMIT_BYTES


@functools.lru_cache(maxsize=16)
def _tables(h: int, w: int, dx: float, closed: bool, device: torch.device):
    """(Qy, Qx, 1/λ) on `device`: DCT-II and the Neumann eigenvalues on a
    closed domain, DST-I and the Dirichlet ones on an open domain."""
    if closed:
        qy, qx = _dct_matrix(h), _dct_matrix(w)
        inv_lam = _inv_neumann_eigenvalues(h, w, dx)
    else:
        qy, qx = _dst_matrix(h), _dst_matrix(w)
        inv_lam = _inv_dirichlet_eigenvalues(h, w, dx)
    return tuple(torch.tensor(a, device=device) for a in (qy, qx, inv_lam))


def pcg_plain(div, acc_y, acc_x, fluid, x0=None, *, dx: float = 1.0,
              closed: bool = True, tol: float = 1e-5, maxiter: int = 500,
              precond: bool = True):
    """`pcg_core` in torch, batched: each sample runs its own CG and freezes
    once it has converged or its residual reached 4× its best. Returns the
    best iterate (B, H, W) and each sample's trip count (B,) int32."""
    b_, h, w = div.shape
    inv_dx2 = 1.0 / (dx * dx)
    is_fluid = fluid > 0
    n_fluid = torch.clamp(fluid.sum(), min=1.0)

    def dot(a, b):
        return torch.sum(a * b, dim=(1, 2), keepdim=True)

    def project(p):
        if not closed:
            return p
        mean = dot(p, fluid) / n_fluid
        return torch.where(is_fluid, p - mean, p)

    def apply_a(p):
        dy = p[:, 1:, :] - p[:, :-1, :]
        dxx = p[:, :, 1:] - p[:, :, :-1]
        if closed:
            zy = torch.zeros_like(p[:, :1, :])
            gy = torch.cat([zy, dy, zy], dim=1)
            zx = torch.zeros_like(p[:, :, :1])
            gx = torch.cat([zx, dxx, zx], dim=2)
        else:
            gy = torch.cat([p[:, :1, :], dy, -p[:, -1:, :]], dim=1)
            gx = torch.cat([p[:, :, :1], dxx, -p[:, :, -1:]], dim=2)
        gy = gy * acc_y
        gx = gx * acc_x
        lap = (gy[:, 1:, :] - gy[:, :-1, :] + gx[:, :, 1:] - gx[:, :, :-1]) * inv_dx2
        return torch.where(is_fluid, -lap, p)

    if precond:
        qy, qx, inv_lam = _tables(h, w, float(dx), bool(closed), div.device)

        def apply_m(r):
            rh = torch.matmul(torch.matmul(qy, r), qx.T)
            return project(torch.matmul(torch.matmul(qy.T, rh * inv_lam), qx))
    else:

        def apply_m(r):
            return r

    b = project(torch.where(is_fluid, -div, 0.0))
    if x0 is not None:
        x = project(torch.where(is_fluid, x0, 0.0))
        r = b - apply_a(x)
    else:
        x = torch.zeros_like(b)
        r = b
    z = apply_m(r)
    d = z
    rz = dot(r, z)
    rs = dot(r, r)
    b2 = torch.clamp(dot(b, b), min=1e-30)
    tol2 = tol * tol
    x_best, rs_best = x, rs
    iters = torch.zeros(b_, dtype=torch.int32, device=div.device)
    for _ in range(maxiter):
        act = (rs / b2 > tol2) & (rs < 4.0 * rs_best)
        if not bool(act.any()):
            break
        ad = apply_a(d)
        dad = dot(d, ad)
        ok = dad > 0
        alpha = torch.where(ok, rz / torch.where(ok, dad, 1.0), 0.0)
        x_new = x + alpha * d
        r_new = r - alpha * ad
        z = apply_m(r_new)
        rz_new = dot(r_new, z)
        rs_new = dot(r_new, r_new)
        beta = torch.where(ok, rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
        d_new = z + beta * d
        better = act & (rs_new < rs_best)
        x_best = torch.where(better, x_new, x_best)
        rs_best = torch.where(act, torch.minimum(rs_new, rs_best), rs_best)
        x = torch.where(act, x_new, x)
        r = torch.where(act, r_new, r)
        d = torch.where(act, d_new, d)
        rz = torch.where(act, rz_new, rz)
        rs = torch.where(act, rs_new, rs)
        iters += act.view(-1).to(torch.int32)
    return x_best, iters


@functools.lru_cache(maxsize=1)
def _kernel():
    from pde_control_tpu_torch.ops._build import load

    lib, _ = load()
    fn = lib.pcg_solve_f32
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 10 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, shape: tuple, device,
           dtype: torch.dtype = torch.float32) -> None:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: want {str(dtype).removeprefix('torch.')} on "
                         f"{device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: want shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _runs_plain(t: torch.Tensor, fn: str) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA one
    (the kernel launches); a tensor on any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{fn} takes CPU or CUDA tensors, got {t.device}")
    return False


def pressure_solve(div, acc_y, acc_x, fluid, x0=None, *, dx: float = 1.0,
                   closed: bool = True, tol: float = 1e-5, maxiter: int = 500,
                   precond: bool = True):
    """Solve the masked pressure-Poisson system, one solve per sample.

    Args:
      div: (B, H, W) float32 velocity divergence; the solve's rhs is
        project(where(fluid, -div, 0)).
      acc_y, acc_x, fluid: the domain's (H+1, W), (H, W+1), (H, W) masks.
      x0: optional (B, H, W) warm start; None solves cold and reads nothing.
      precond: apply the spectral preconditioner.
    Returns: (p (B, H, W), trip counts (B,) int32); p has zero fluid mean
    on a closed domain.
    """
    global LAUNCHES
    if _runs_plain(div, "pressure_solve"):
        return pcg_plain(div, acc_y, acc_x, fluid, x0, dx=dx, closed=closed,
                         tol=tol, maxiter=maxiter, precond=precond)
    if div.dim() != 3:
        raise ValueError(f"div: want (B, H, W), got {tuple(div.shape)}")
    b, h, w = div.shape
    dev = div.device
    _check("div", div, (b, h, w), dev)
    _check("acc_y", acc_y, (h + 1, w), dev)
    _check("acc_x", acc_x, (h, w + 1), dev)
    _check("fluid", fluid, (h, w), dev)
    if x0 is not None:
        _check("x0", x0, (b, h, w), dev)
    if not cuda_solve_fits(h, w):
        raise ValueError(f"a {h}x{w} solve does not fit in one block's shared "
                         f"memory ({SMEM_LIMIT_BYTES} bytes)")
    qy, qx, inv_lam = _tables(h, w, float(dx), bool(closed), dev)
    out = torch.empty_like(div)
    iters = torch.empty(b, dtype=torch.int32, device=dev)
    rc = _kernel()(
        div.data_ptr(), None if x0 is None else x0.data_ptr(),
        acc_y.data_ptr(), acc_x.data_ptr(), fluid.data_ptr(), qy.data_ptr(),
        qx.data_ptr(), inv_lam.data_ptr(), out.data_ptr(), iters.data_ptr(),
        b, h, w, float(dx), int(closed), float(tol), int(maxiter),
        int(precond), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pcg_solve_f32 launch failed with cudaError {rc}")
    LAUNCHES += 1
    return out, iters
