"""Fused, spectrally preconditioned CG pressure solve: the Hopper kernel
(`csrc/pcg.cu`) and its plain PyTorch version.

Replaces the TPU kernel `pde_control_tpu/ops/pallas_cg.py ::
pallas_pressure_solve` (body `_pcg_kernel` → `pcg_core`). One thread-block
cluster solves one sample's masked pressure-Poisson system and runs the
whole CG loop on the card: its C blocks each own a band of rows, with the
iterates in shared memory (`csrc/pcg_cluster.cuh`, the loop K2 and K3 run
too; the source's header gives the layouts). `solve_plan` picks C. The
grid picks the layout (`layout`): the small one where its buffers fit a
block under some cluster size (to 111² on squares); else the core's large
layout, the basis read from L2 and the residual exchanged by bands, one
more cluster barrier a trip (112² to 153²); else the banded one, where no
whole field stays in shared memory and the residual and the scaled
spectrum go whole through a scratch in global memory (L2), which the
wrapper allocates (from 154²). So K1 takes every grid the Pallas kernel's
VMEM gate `pallas_solve_fits` admits (to 351² warm and 362² cold on
squares) and wider ones, as far as a plan fits shared memory.

What bounds it on this card: latency, not bytes or FLOPs. Each trip is a
chain of cluster barriers around four small fp32 basis products; the
cluster spreads a batch of B samples over B·C of the H100's 132 SMs, so
each block computes 1/C of every product, and the loop and its per-sample
exit live on the card (no host round trip, no launch per trip). In the
large and banded layouts the products also read the basis from L2, in
the banded one the whole residual and spectrum too.

`pressure_solve` launches the kernel for CUDA tensors and runs `pcg_plain`,
a transcription of `pcg_core` in torch, for CPU tensors; a CUDA tensor it
cannot take (dtype, shape, layout, a grid `cuda_solve_fits` refuses)
raises, and so does a launch that fails under its plan: nothing falls
back. `LAUNCHES` counts the kernel's launches.

`pick_plan` is the rule by which all three cluster kernels (K1 here, K2
and K3 in `cuda_fluid`) choose their cluster size.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import numpy as np
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
# The cluster kernels' cluster sizes and threads per block (their launchers
# refuse others).
CLUSTERS = (1, 2, 4, 8, 16)
CLUSTER_THREADS = 512
# K1's layouts of a rank's shared memory (`pcg_cluster.cuh :: kLayout*`).
SMALL, LARGE, BANDED = 0, 1, 2
LAYOUT_NAMES = ("small", "large", "banded")
_RED_FLOATS = 2 * 4 * 16 + 4 * 16  # the cluster reduction's slots


def _align4(n: int) -> int:
    return (n + 3) & ~3


def _cg_floats(h: int, w: int, rows: int, threads: int,
               layout: int = SMALL) -> int:
    """Floats of one rank's cluster-solve buffers (`pcg_cluster.cuh ::
    take_cg`): the basis, three whole fields, the band's iterates with d's
    halo rows, z's halo rows and the products' slices, each 16-byte
    aligned; the large layout (`layout` LARGE, or True) has neither the
    basis nor the third whole field (A d), the banded one no whole field
    but the band of r."""
    basis = h * (h + 1) + (0 if h == w else w * (w + 1))
    whole = {SMALL: (basis, h * w, h * w, h * w), LARGE: (h * w, h * w),
             BANDED: (rows * w,)}[int(layout)]
    return sum(_align4(n) for n in (
        *whole, rows * w, (rows + 2) * w, rows * w, rows * w, 2 * w,
        8 * threads))


def _solve_bytes(h: int, w: int, cluster: int, threads: int,
                 layout: int) -> int:
    return 4 * (_align4(_RED_FLOATS)
                + _cg_floats(h, w, -(-h // cluster), threads, layout))


def layout_where_fits(h: int, count: Callable[[int, int], int]) -> int:
    """The layout of a cluster kernel at an H-row grid whose shared memory
    is `count(cluster, layout)` bytes a block: SMALL where it fits a block
    under some cluster size, else LARGE where that fits, else BANDED; so
    that every plan of a grid keeps one layout (`pcg_cluster.cuh ::
    layout_where_fits`). K1, K2 and K3 each decide by it, on their own
    bytes."""
    for kind in (SMALL, LARGE):
        if any(count(c, kind) <= SMEM_LIMIT_BYTES for c in CLUSTERS if c <= h):
            return kind
    return BANDED


@functools.lru_cache(maxsize=None)
def layout(h: int, w: int, threads: int = CLUSTER_THREADS) -> int:
    """The layout in which K1 solves an H x W grid, by `layout_where_fits`
    (`pcg.cu :: grid_layout`, which `pcg_layout` reports in C)."""
    return layout_where_fits(
        h, lambda c, kind: _solve_bytes(h, w, c, threads, kind))


def solve_shared_bytes(h: int, w: int, cluster: int, threads: int) -> int:
    """Shared memory one rank of K1 needs: the reduction area and the
    solve's buffers for bands of ceil(H / cluster) rows, in the grid's
    layout — the count `pcg_shared_bytes` makes in C."""
    return _solve_bytes(h, w, cluster, threads, layout(h, w, threads))


class ClusterPlan(NamedTuple):
    """How a cluster kernel runs one batch: a cluster of `cluster` blocks
    of `threads` threads per sample, each rank owning at most
    `rows_per_rank` rows, with `shared_bytes` of shared memory a block."""
    cluster: int
    threads: int
    rows_per_rank: int
    shared_bytes: int


def cluster_plans(h: int, count: Callable[[int], int]) -> list[ClusterPlan]:
    """Every plan a cluster launcher takes at H rows: each cluster size up
    to H whose shared memory, `count(cluster)` bytes, fits a block."""
    return [ClusterPlan(c, CLUSTER_THREADS, -(-h // c), nbytes)
            for c in CLUSTERS
            if c <= h and (nbytes := count(c)) <= SMEM_LIMIT_BYTES]


def pick_plan(batch: int, plans: list[ClusterPlan],
              max_clusters: Callable[[int, int, int], int],
              sm_count: int | None = None) -> ClusterPlan:
    """The rule of K1's, K2's and K3's plans: among `plans` (ascending
    cluster sizes), the smallest C with batch·C at least the card's SM
    count (or the largest), then the next smaller C while fewer than
    `batch` clusters can be resident at once (`max_clusters(cluster,
    threads, shared_bytes)`, the card's `cudaOccupancyMaxActiveClusters`
    for the kernel). `sm_count` defaults to the current card's."""
    if sm_count is None:
        sm_count = torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
    i = next((i for i, p in enumerate(plans) if batch * p.cluster >= sm_count),
             len(plans) - 1)
    while i > 0 and max_clusters(plans[i].cluster, plans[i].threads,
                                 plans[i].shared_bytes) < batch:
        i -= 1
    return plans[i]


def card_max_clusters(query: Callable[..., int], *args) -> Callable:
    """`max_clusters` for `pick_plan` from a C entry `query(*args, cluster,
    threads)` that returns the resident clusters or minus a cudaError_t."""
    def max_clusters(cluster, threads, _shared_bytes):
        n = query(*args, cluster, threads)
        if n < 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with "
                               f"cudaError {-n}")
        return n
    return max_clusters


def solve_plans(h: int, w: int) -> list[ClusterPlan]:
    """Every plan the K1 launcher takes at H x W."""
    return cluster_plans(h, lambda c: solve_shared_bytes(h, w, c,
                                                         CLUSTER_THREADS))


@functools.lru_cache(maxsize=None)
def solve_plan(batch: int, h: int, w: int, *, sm_count: int | None = None,
               max_clusters: Callable[[int, int, int], int] | None = None
               ) -> ClusterPlan:
    """K1's plan for `batch` samples of H x W, by `pick_plan`. Raises if
    no cluster size fits."""
    plans = solve_plans(h, w)
    if not plans:
        raise ValueError(f"no cluster size fits K1's {h}x{w} solve in a block's "
                         f"shared memory ({SMEM_LIMIT_BYTES} bytes)")
    if max_clusters is None:
        max_clusters = card_max_clusters(_kernel()[1], h, w)
    return pick_plan(batch, plans, max_clusters, sm_count)


def cuda_solve_fits(h: int, w: int) -> bool:
    """Whether K1 takes an H x W grid: some cluster plan of the grid's
    layout fits shared memory. True wherever `pallas_solve_fits` is, warm
    or cold."""
    return bool(solve_plans(h, w))


@functools.lru_cache(maxsize=16)
def _tables(h: int, w: int, dx: float, closed: bool, device: torch.device):
    """(Qy, Qx, 1/λ, Qxᵀ) on `device`: DCT-II and the Neumann eigenvalues
    on a closed domain, DST-I and the Dirichlet ones on an open domain;
    Qxᵀ (contiguous) for the kernel's large and banded layouts."""
    if closed:
        qy, qx = _dct_matrix(h), _dct_matrix(w)
        inv_lam = _inv_neumann_eigenvalues(h, w, dx)
    else:
        qy, qx = _dst_matrix(h), _dst_matrix(w)
        inv_lam = _inv_dirichlet_eigenvalues(h, w, dx)
    return tuple(torch.tensor(np.ascontiguousarray(a), device=device)
                 for a in (qy, qx, inv_lam, qx.T))


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
        qy, qx, inv_lam, _ = _tables(h, w, float(dx), bool(closed),
                                     div.device)

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
    """The C entries: the solve's launch and its resident-cluster query."""
    from pde_control_tpu_torch.ops._build import load

    lib, _ = load()
    fn = lib.pcg_solve_f32
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 12 + [i32] * 3 + [
        ctypes.c_float, i32, ctypes.c_float, i32, i32, i32, i32, ptr]
    fn.restype = i32
    clusters = lib.pcg_max_clusters
    clusters.argtypes = [i32] * 4
    clusters.restype = i32
    return fn, clusters


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
    kw = dict(dx=dx, closed=closed, tol=tol, maxiter=maxiter, precond=precond)
    if _runs_plain(div, "pressure_solve"):
        return pcg_plain(div, acc_y, acc_x, fluid, x0, **kw)
    return _launch_solve(div, acc_y, acc_x, fluid, x0, None, **kw)


def _launch_solve(div, acc_y, acc_x, fluid, x0, plan: ClusterPlan | None, *,
                  dx: float, closed: bool, tol: float, maxiter: int,
                  precond: bool):
    """Launches K1 on CUDA tensors under `plan` (None: `solve_plan`'s).
    The tests and `sweep_dw_plan.py cg` pass other plans; a plan the
    launcher refuses raises."""
    global LAUNCHES
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
        raise ValueError(f"a {h}x{w} solve is beyond K1's grids (no plan of "
                         f"its {LAYOUT_NAMES[layout(h, w)]} layout fits a "
                         f"cluster's shared memory, {SMEM_LIMIT_BYTES} bytes "
                         f"a block)")
    if plan is None:
        plan = solve_plan(b, h, w)
    qy, qx, inv_lam, qxt = _tables(h, w, float(dx), bool(closed), dev)
    out = torch.empty_like(div)
    iters = torch.empty(b, dtype=torch.int32, device=dev)
    # The banded layout's r and scaled spectrum, whole, for every sample.
    scratch = (torch.empty((b, 2, h, w), dtype=torch.float32, device=dev)
               if layout(h, w) == BANDED else None)
    rc = _kernel()[0](
        div.data_ptr(), None if x0 is None else x0.data_ptr(),
        acc_y.data_ptr(), acc_x.data_ptr(), fluid.data_ptr(), qy.data_ptr(),
        qx.data_ptr(), qxt.data_ptr(), inv_lam.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        iters.data_ptr(),
        b, h, w, float(dx), int(closed), float(tol), int(maxiter),
        int(precond), plan.cluster, plan.threads,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pcg_solve_f32 launch failed with cudaError {rc} "
                           f"under {plan}")
    LAUNCHES += 1
    return out, iters
