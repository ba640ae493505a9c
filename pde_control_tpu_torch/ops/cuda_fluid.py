"""The whole 2D fluid step as one kernel per direction: the Hopper kernels
(`csrc/fused_step.cu`) and their plain PyTorch versions.

Replaces the TPU kernels `pde_control_tpu/ops/pallas_fluid.py ::
_make_fused_step._forward` (K2, body `_fwd_kernel`) and `._backward` (K3,
body `_bwd_kernel`). Each runs a batch sample on a thread-block cluster of
C blocks, each owning a band of rows. K2 runs one step of the
closed-domain smoke physics: shift advection of the density and both MAC
velocity components, inflow, force, buoyancy, the masks, the divergence,
the spectrally preconditioned CG solve warm-started from the previous
pressure (`csrc/pcg_cluster.cuh`, the loop K1 and K3 run) and the
pressure-gradient correction. K3 is the hand-written VJP of K2: a cold
transpose solve on the pressure cotangent, the stencil and face/centre
adjoints, and the three advection-window adjoints with JAX's tie rules.
The displacements are recomputed from the step's inputs, which are all
that is saved between the two directions.

What bounds them on this card: latency, as for K1. Each CG trip is a
chain of cluster barriers around four small basis products; `fwd_plan`
and `bwd_plan` pick C by `cuda_cg.pick_plan` (the smallest C up to 16
that fills the card, if that many clusters can be resident), so a trip
and the windows are 1/C of the work on each SM. The design keeps the
whole step in one launch per direction with no host round trip. Each
kernel takes a layout of the cluster core per grid, by K1's rule
(`fwd_layout`, `bwd_layout`): small where its buffers fit a block under
some cluster size; else the large layout (K2 from 109², K3 from 112² at
max_shift 2), the basis read from L2 and the residual exchanged by
bands; else the banded one (K2 from 146², K3 from 152²), the solve's two
whole fields in a scratch in global memory that the wrapper allocates
and, in K3, the window phase's arrays too (`bwd_scratch_floats`). The
grids are those of the JAX package's fused gate (`pallas_fused_domain`),
to 236² on squares, every one of which has a plan of each kernel.

`fused_step_forward` / `fused_step_backward` launch K2 / K3 for CUDA
tensors and run the plain versions below for CPU tensors; a CUDA tensor
they cannot take (dtype, shape, layout, a grid `fused_step_fits` refuses)
raises, and so does a launch that fails under its plan: nothing falls
back. `LAUNCHES_FWD` and `LAUNCHES_BWD` count the launches.
`fused_fluid_step` is the differentiable step (`_FusedStep`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch
from torch.autograd.function import once_differentiable

from pde_control_tpu_torch.ops import cuda_cg
from pde_control_tpu_torch.ops.interp import (
    _clip_grad,
    _hat,
    _hat_grad,
    _pad2,
    _pad2_T,
)

#: Launches of K2 (forward) and K3 (backward) since import, or since a
#: caller reset them.
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0

# The JAX package's fused-step domain, `pde_control_tpu/ops/pallas_fluid.py
# :: fused_step_fits`: its conservative count of the Pallas kernels' VMEM
# (~40 field-size values padded to the TPU's (8, 128) tiles and the two
# spectral bases) under a 10 MiB budget. A TPU bound, not a fit of this
# card; `fused_step_fits` keeps the port's fused step to it, so that
# fused='cuda' takes exactly the grids fused='pallas' takes.
_PALLAS_VMEM_BUDGET_BYTES = 10 * 1024 * 1024


def pallas_fused_domain(h: int, w: int) -> bool:
    """Whether the JAX package's fused-step gate admits an H x W grid (a
    copy of its formula; the port imports nothing of the JAX package):
    squares to 236², tall grids to ~431 rows, wide ones to ~994 columns."""
    per_field = (h + 8) * max(w + 8, 128) * 4
    basis = (h * max(h, 128) + w * max(w, 128)) * 4
    return 40 * per_field + 2 * basis < _PALLAS_VMEM_BUDGET_BYTES


def _fwd_bytes(h: int, w: int, cluster: int, threads: int,
               layout: int) -> int:
    r, align4 = -(-h // cluster), cuda_cg._align4
    return 4 * (align4(cuda_cg._RED_FLOATS)
                + cuda_cg._cg_floats(h, w, r, threads, layout)
                + align4((r + 1) * w) + align4(r * (w + 1))
                + align4(min(r + 2, h) * w) + align4(w))


@functools.lru_cache(maxsize=None)
def fwd_layout(h: int, w: int, threads: int = cuda_cg.CLUSTER_THREADS) -> int:
    """The cluster core's layout in which K2 runs an H x W grid
    (`cuda_cg.SMALL`, `LARGE` or `BANDED`), by `cuda_cg.layout_where_fits`
    on K2's bytes (`fused_step.cu :: fwd_grid_layout`, which
    `fused_fwd_layout` reports in C)."""
    return cuda_cg.layout_where_fits(
        h, lambda c, kind: _fwd_bytes(h, w, c, threads, kind))


def fwd_shared_bytes(h: int, w: int, cluster: int, threads: int) -> int:
    """Shared memory one rank of K2 needs: the reduction area, the solve's
    buffers in the grid's layout, then the band's vy3 (one more y-face),
    vx3, rho1 (one more row each side, clipped to the grid) and the row of
    p above the band — the count `fused_fwd_shared_bytes` makes in C."""
    return _fwd_bytes(h, w, cluster, threads, fwd_layout(h, w, threads))


def fwd_plans(h: int, w: int) -> list[cuda_cg.ClusterPlan]:
    """Every plan the K2 launcher takes at H x W."""
    return cuda_cg.cluster_plans(h, lambda c: fwd_shared_bytes(
        h, w, c, cuda_cg.CLUSTER_THREADS))


@functools.lru_cache(maxsize=None)
def fwd_plan(batch: int, h: int, w: int, *, sm_count: int | None = None,
             max_clusters: Callable[[int, int, int], int] | None = None
             ) -> cuda_cg.ClusterPlan:
    """K2's plan for `batch` samples of H x W, by `cuda_cg.pick_plan`.
    Raises if no cluster size fits."""
    plans = fwd_plans(h, w)
    if not plans:
        raise ValueError(f"no cluster size fits K2's {h}x{w} step in a block's "
                         f"shared memory ({cuda_cg.SMEM_LIMIT_BYTES} bytes)")
    if max_clusters is None:
        max_clusters = cuda_cg.card_max_clusters(_kernels()[3], h, w)
    return cuda_cg.pick_plan(batch, plans, max_clusters, sm_count)


@functools.lru_cache(maxsize=None)
def fused_step_fits(h: int, w: int, max_shift: int = 2) -> bool:
    """Whether the fused step takes an H x W grid at `max_shift`: the JAX
    package's fused gate admits it (`pallas_fused_domain`; it ignores
    max_shift), and both K2 and K3 (at this max_shift) have a plan that
    fits shared memory. Outside that domain it says no even where a plan
    fits (237², 256²). Cached: every launch asks."""
    return (pallas_fused_domain(h, w) and bool(fwd_plans(h, w))
            and bool(bwd_plans(h, w, max_shift)))


# K3's cluster sizes and its threads per block (the launcher refuses others).
BWD_CLUSTERS = cuda_cg.CLUSTERS
BWD_THREADS = cuda_cg.CLUSTER_THREADS


def _window_floats(h: int, w: int, rows: int, max_shift: int) -> int:
    """Floats of one rank's window phase in K3 (`fused_step.cu ::
    bwd_layout`, gdiv to tmp): twelve arrays on the band of `rows` rows
    widened by max_shift + 1 rows, each 16-byte aligned."""
    r, e, align4 = rows, max_shift + 1, cuda_cg._align4
    taps = min(r + 2 * e + 1, h + 1) * (w + 1)
    return sum(align4(n) for n in (
        min(r + 2 * e + 2, h) * w, min(r + 2 * e + 1, h + 1) * w,
        min(r + 2 * e, h) * (w + 1), min(r + 2 * e, h) * w, taps, taps, taps,
        taps, taps, min(r + 1, h) * w, min(r + 1, h) * w,
        min(r + 1, h + 1) * (w + 1)))


def _bwd_bytes(h: int, w: int, cluster: int, threads: int, max_shift: int,
               layout: int) -> int:
    r, align4 = -(-h // cluster), cuda_cg._align4
    persistent = align4(cuda_cg._RED_FLOATS) + align4(r * w)
    solve = cuda_cg._cg_floats(h, w, r, threads, layout)
    if layout == cuda_cg.BANDED:  # the window phase in global memory
        return 4 * (persistent + solve)
    return 4 * (persistent + max(solve, _window_floats(h, w, r, max_shift)))


@functools.lru_cache(maxsize=None)
def bwd_layout(h: int, w: int, max_shift: int = 2,
               threads: int = BWD_THREADS) -> int:
    """The cluster core's layout in which K3 runs an H x W grid at
    `max_shift`, by `cuda_cg.layout_where_fits` on K3's bytes
    (`fused_step.cu :: bwd_grid_layout`, which `fused_bwd_layout` reports
    in C). BANDED takes the window phase out of shared memory too."""
    return cuda_cg.layout_where_fits(
        h, lambda c, kind: _bwd_bytes(h, w, c, threads, max_shift, kind))


def bwd_shared_bytes(h: int, w: int, cluster: int, threads: int,
                     max_shift: int) -> int:
    """Shared memory one rank of K3 needs: the reduction area and the best
    iterate's band, then the larger of the solve's buffers in the grid's
    layout (the small one: the basis, three whole fields, the band's
    iterates, the products' slices; the large one without the basis and the
    third whole field) and the window phase's (the band widened by
    max_shift + 1 rows); in the banded layout the solve's buffers alone,
    its window phase being in `bwd_scratch_floats`' scratch — the count
    `fused_bwd_shared_bytes` makes in C."""
    return _bwd_bytes(h, w, cluster, threads, max_shift,
                      bwd_layout(h, w, max_shift, threads))


def bwd_scratch_floats(h: int, w: int, cluster: int, max_shift: int) -> int:
    """Floats of global scratch one sample of K3 needs in the banded
    layout: the solve's two whole fields (H x W each), then each rank's
    window phase (`_window_floats`) — the count `fused_bwd_scratch_floats`
    makes in C."""
    return cuda_cg._align4(2 * h * w) + cluster * _window_floats(
        h, w, -(-h // cluster), max_shift)


def bwd_plans(h: int, w: int,
              max_shift: int = 2) -> list[cuda_cg.ClusterPlan]:
    """Every plan the K3 launcher takes at H x W: each cluster size up to H
    whose shared memory fits a block."""
    return cuda_cg.cluster_plans(h, lambda c: bwd_shared_bytes(
        h, w, c, BWD_THREADS, max_shift))


@functools.lru_cache(maxsize=None)
def bwd_plan(batch: int, h: int, w: int, max_shift: int = 2, *,
             sm_count: int | None = None,
             max_clusters: Callable[[int, int, int], int] | None = None
             ) -> cuda_cg.ClusterPlan:
    """K3's plan for `batch` samples of H x W, by `cuda_cg.pick_plan`: the
    smallest cluster size C (a power of two, at most 16 and at most H) with
    batch·C at least the card's SM count (or the largest that fits), among
    those whose shared memory fits a block; then the next smaller C while
    fewer than `batch` clusters can be resident at once. `sm_count` and
    `max_clusters(cluster, threads, shared_bytes)` default to the current
    card's (its SM count and `cudaOccupancyMaxActiveClusters`). Raises if
    no cluster size fits."""
    plans = bwd_plans(h, w, max_shift)
    if not plans:
        raise ValueError(f"no cluster size fits K3's {h}x{w} step in a block's "
                         f"shared memory ({cuda_cg.SMEM_LIMIT_BYTES} bytes)")
    if max_clusters is None:
        query = _kernels()[2]
        max_clusters = cuda_cg.card_max_clusters(
            lambda c, t: query(h, w, c, t, max_shift))
    return cuda_cg.pick_plan(batch, plans, max_clusters, sm_count)


# --------------------------------------------------------------------------
# Plain versions: batched transcriptions of the JAX helpers. Fields carry a
# leading batch axis; the geometry (acc_y, acc_x, fluid) broadcasts.
# --------------------------------------------------------------------------


def _advect_window(f, dy, dx_, k: int):
    """out[i,j] = bilerp(f, i+dy, j+dx_), |displacement| clipped to k, clamp
    boundary (edge-padded k before and k+1 after), as the factored (2k+2)²
    hat-window sum."""
    m, n = f.shape[-2:]
    dyc = torch.clamp(dy, -k, k)
    dxc = torch.clamp(dx_, -k, k)
    fp = _pad2(f, k, "clamp")
    offs = range(-k, k + 2)
    wys = [_hat(dyc - oy) for oy in offs]
    wxs = [_hat(dxc - ox) for ox in offs]
    out = torch.zeros_like(f)
    for iy, oy in enumerate(offs):
        row = fp[..., k + oy:k + oy + m, :]
        inner = torch.zeros_like(f)
        for ix, ox in enumerate(offs):
            inner = inner + row[..., k + ox:k + ox + n] * wxs[ix]
        out = out + inner * wys[iy]
    return out


def _advect_window_T(g, f, dy, dx_, k: int):
    """Adjoint of `_advect_window`: (ḡf, ḡdy, ḡdx) from the output
    cotangent g. The field cotangent scatters g·w back by the reverse shift
    into the padded grid and folds the margins onto the edges; the
    displacement cotangents are hat-derivative windows chained through the
    clip, with JAX's tie rules."""
    m, n = f.shape[-2:]
    dyc = torch.clamp(dy, -k, k)
    dxc = torch.clamp(dx_, -k, k)
    fp = _pad2(f, k, "clamp")
    offs = range(-k, k + 2)
    wys = [_hat(dyc - oy) for oy in offs]
    wyps = [_hat_grad(dyc - oy) for oy in offs]
    wxs = [_hat(dxc - ox) for ox in offs]
    wxps = [_hat_grad(dxc - ox) for ox in offs]
    gwxs = [g * w for w in wxs]
    gwxps = [g * w for w in wxps]
    s_dy = torch.zeros_like(f)
    s_dx = torch.zeros_like(f)
    acc = f.new_zeros(f.shape[:-2] + (m + 2 * k + 1, n + 2 * k + 1))
    for iy, oy in enumerate(offs):
        row = fp[..., k + oy:k + oy + m, :]
        ady = torch.zeros_like(f)
        adx = torch.zeros_like(f)
        for ix, ox in enumerate(offs):
            val = row[..., k + ox:k + ox + n]
            ady = ady + val * gwxs[ix]
            adx = adx + val * gwxps[ix]
            acc[..., k + oy:k + oy + m, k + ox:k + ox + n] += gwxs[ix] * wys[iy]
        s_dy = s_dy + ady * wyps[iy]
        s_dx = s_dx + adx * wys[iy]
    g_f = _pad2_T(acc, m, n, k, "clamp")
    return g_f, s_dy * _clip_grad(dy, k), s_dx * _clip_grad(dx_, k)


def _to_y_faces(c):
    """(B, M, N) centred → (B, M+1, N) y-faces, edge clamp."""
    cp = torch.cat([c[:, :1], c, c[:, -1:]], dim=1)
    return 0.5 * (cp[:, :-1] + cp[:, 1:])


def _to_y_faces_T(g):
    mid = 0.5 * (g[:, :-1] + g[:, 1:])
    first = mid[:, :1] + 0.5 * g[:, :1]
    last = mid[:, -1:] + 0.5 * g[:, -1:]
    return torch.cat([first, mid[:, 1:-1], last], dim=1)


def _to_x_faces(c):
    cp = torch.cat([c[:, :, :1], c, c[:, :, -1:]], dim=2)
    return 0.5 * (cp[:, :, :-1] + cp[:, :, 1:])


def _to_x_faces_T(g):
    mid = 0.5 * (g[:, :, :-1] + g[:, :, 1:])
    first = mid[:, :, :1] + 0.5 * g[:, :, :1]
    last = mid[:, :, -1:] + 0.5 * g[:, :, -1:]
    return torch.cat([first, mid[:, :, 1:-1], last], dim=2)


def _centers_y(vy):
    """(B, M+1, N) y-faces → (B, M, N) centres."""
    return 0.5 * (vy[:, :-1] + vy[:, 1:])


def _centers_y_T(gc):
    z = torch.zeros_like(gc[:, :1])
    return 0.5 * (torch.cat([z, gc], dim=1) + torch.cat([gc, z], dim=1))


def _centers_x(vx):
    return 0.5 * (vx[:, :, :-1] + vx[:, :, 1:])


def _centers_x_T(gc):
    z = torch.zeros_like(gc[:, :, :1])
    return 0.5 * (torch.cat([z, gc], dim=2) + torch.cat([gc, z], dim=2))


def _divergence(vy, vx, dx: float):
    return ((vy[:, 1:] - vy[:, :-1]) + (vx[:, :, 1:] - vx[:, :, :-1])) / dx


def _divergence_T(c, dx: float):
    zy = torch.zeros_like(c[:, :1])
    gy = (torch.cat([zy, c], dim=1) - torch.cat([c, zy], dim=1)) / dx
    zx = torch.zeros_like(c[:, :, :1])
    gx = (torch.cat([zx, c], dim=2) - torch.cat([c, zx], dim=2)) / dx
    return gy, gx


def _pgrad_closed(p, acc_y, acc_x, dx: float):
    """Gated pressure gradient on the faces, zero on the closed walls."""
    zy = torch.zeros_like(p[:, :1])
    gy = torch.cat([zy, (p[:, 1:] - p[:, :-1]) / dx, zy], dim=1) * acc_y
    zx = torch.zeros_like(p[:, :, :1])
    gx = torch.cat([zx, (p[:, :, 1:] - p[:, :, :-1]) / dx, zx], dim=2) * acc_x
    return gy, gx


def _phase_a(vy, vx, rho, fy, fx, inflow, acc_y, acc_x, *, dt: float,
             dx: float, k: int, buoy: float):
    """Everything before the solve, in the order of physics/fluid.py ::
    fluid_step: (vy3, vx3, rho1, div)."""
    s = -dt / dx
    vy_c = _centers_y(vy)
    vx_c = _centers_x(vx)
    rho1 = _advect_window(rho, s * vy_c, s * vx_c, k)
    if inflow is not None:
        rho1 = rho1 + dt * inflow
    vy1 = _advect_window(vy, s * vy, s * _to_y_faces(vx_c), k)
    vx1 = _advect_window(vx, s * _to_x_faces(vy_c), s * vx, k)
    vy2, vx2 = vy1, vx1
    if fy is not None:
        vy2 = vy2 + dt * fy
        vx2 = vx2 + dt * fx
    if buoy:
        vy2 = vy2 + (dt * buoy) * _to_y_faces(rho1)
    vy3 = vy2 * acc_y
    vx3 = vx2 * acc_x
    return vy3, vx3, rho1, _divergence(vy3, vx3, dx)


def fused_step_plain_forward(vy, vx, rho, acc_y, acc_x, fluid, fy=None,
                             fx=None, inflow=None, x0=None, *, dt: float,
                             dx: float, max_shift: int, buoyancy: float,
                             closed: bool, tol: float, maxiter: int):
    """K2's plain version (`_fwd_kernel`): (vy4, vx4, rho1, p, trip counts)."""
    vy3, vx3, rho1, div = _phase_a(vy, vx, rho, fy, fx, inflow, acc_y, acc_x,
                                   dt=dt, dx=dx, k=max_shift, buoy=buoyancy)
    p, iters = cuda_cg.pcg_plain(div, acc_y, acc_x, fluid, x0, dx=dx,
                                 closed=closed, tol=tol, maxiter=maxiter)
    gy, gx = _pgrad_closed(p, acc_y, acc_x, dx)
    return vy3 - gy, vx3 - gx, rho1, p, iters


def fused_step_plain_backward(vy, vx, rho, g_vy4, g_vx4, g_rho1, g_p, acc_y,
                              acc_x, fluid, *, dt: float, dx: float,
                              max_shift: int, buoyancy: float, closed: bool,
                              tol: float, maxiter: int, has_force: bool,
                              has_inflow: bool):
    """K3's plain version, a transcription of `_bwd_kernel` (the
    hand-written VJP, not autograd of the forward). Returns the cotangents
    of (vy, vx, rho, fy, fx, inflow), None for an operand the step did not
    take, and the transpose solve's trip counts."""
    s = -dt / dx
    k = max_shift
    # Projection backward: v4 = v3 - G p, so cot_p = ḡp + div(acc ⊙ ḡv4);
    # the transpose solve runs cold on -cot_p.
    cot_p = g_p + _divergence(g_vy4 * acc_y, g_vx4 * acc_x, dx)
    xt, iters = cuda_cg.pcg_plain(-cot_p, acc_y, acc_x, fluid, None, dx=dx,
                                  closed=closed, tol=tol, maxiter=maxiter)
    is_fluid = fluid > 0
    if closed:
        n_fluid = torch.clamp(fluid.sum(), min=1.0)
        mean = torch.sum(xt * fluid, dim=(1, 2), keepdim=True) / n_fluid
        xt = torch.where(is_fluid, xt - mean, xt)
    g_div = torch.where(is_fluid, -xt, 0.0)
    gdy, gdx = _divergence_T(g_div, dx)
    g_vy2 = (g_vy4 + gdy) * acc_y
    g_vx2 = (g_vx4 + gdx) * acc_x
    g_rho1_tot = g_rho1
    if buoyancy:
        g_rho1_tot = g_rho1_tot + (dt * buoyancy) * _to_y_faces_T(g_vy2)
    g_fy = dt * g_vy2 if has_force else None
    g_fx = dt * g_vx2 if has_force else None
    g_inflow = dt * g_rho1_tot if has_inflow else None

    # Advection backward, displacements recomputed from the inputs.
    vy_c = _centers_y(vy)
    vx_c = _centers_x(vx)
    g_rho0, g_dyr, g_dxr = _advect_window_T(g_rho1_tot, rho, s * vy_c,
                                            s * vx_c, k)
    g_vyc = s * g_dyr
    g_vxc = s * g_dxr
    g_vy0f, g_dyy, g_dxy = _advect_window_T(g_vy2, vy, s * vy,
                                            s * _to_y_faces(vx_c), k)
    g_vy0 = g_vy0f + s * g_dyy
    g_vxc = g_vxc + _to_y_faces_T(s * g_dxy)
    g_vx0f, g_dyx, g_dxx = _advect_window_T(g_vx2, vx, s * _to_x_faces(vy_c),
                                            s * vx, k)
    g_vx0 = g_vx0f + s * g_dxx
    g_vyc = g_vyc + _to_x_faces_T(s * g_dyx)
    g_vy0 = g_vy0 + _centers_y_T(g_vyc)
    g_vx0 = g_vx0 + _centers_x_T(g_vxc)
    return g_vy0, g_vx0, g_rho0, g_fy, g_fx, g_inflow, iters


# --------------------------------------------------------------------------
# The kernels' wrappers.
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _kernels():
    from pde_control_tpu_torch.ops._build import load

    lib, _ = load()
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i32] * 3 + [f32] * 4 + [i32] * 3 + [f32, i32, i32, i32, ptr]
    fwd = lib.fused_step_fwd_f32
    fwd.argtypes = [ptr] * 20 + tail
    fwd.restype = i32
    bwd = lib.fused_step_bwd_f32
    bwd.argtypes = [ptr] * 22 + tail
    bwd.restype = i32
    bwd_clusters = lib.fused_bwd_max_clusters
    bwd_clusters.argtypes = [i32] * 5
    bwd_clusters.restype = i32
    fwd_clusters = lib.fused_fwd_max_clusters
    fwd_clusters.argtypes = [i32] * 4
    fwd_clusters.restype = i32
    return fwd, bwd, bwd_clusters, fwd_clusters


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda(vy, vx, rho, fields: dict, geom,
                max_shift: int) -> tuple[int, int, int]:
    """Checks every operand of a launch; returns (B, H, W)."""
    if rho.dim() != 3:
        raise ValueError(f"rho: want (B, H, W), got {tuple(rho.shape)}")
    b, h, w = rho.shape
    dev = rho.device
    y_faces, x_faces, cells = (b, h + 1, w), (b, h, w + 1), (b, h, w)
    shapes = dict(vy=y_faces, vx=x_faces, rho=cells, fy=y_faces, fx=x_faces,
                  inflow=cells, x0=cells, g_vy4=y_faces, g_vx4=x_faces,
                  g_rho1=cells, g_p=cells)
    for name, t in dict(vy=vy, vx=vx, rho=rho, **fields).items():
        if t is not None:
            cuda_cg._check(name, t, shapes[name], dev)
    acc_y, acc_x, fluid = geom
    cuda_cg._check("acc_y", acc_y, (h + 1, w), dev)
    cuda_cg._check("acc_x", acc_x, (h, w + 1), dev)
    cuda_cg._check("fluid", fluid, (h, w), dev)
    if not fused_step_fits(h, w, max_shift):
        raise ValueError(f"a {h}x{w} fused step at max_shift {max_shift} is "
                         f"beyond its grids (the JAX package's fused gate, "
                         f"squares up to 236², and a plan of K2 and K3 in a "
                         f"cluster's shared memory, up to "
                         f"{cuda_cg.SMEM_LIMIT_BYTES} bytes a block)")
    return b, h, w


def _statics(dt, dx, max_shift, buoyancy, closed, tol, maxiter):
    """The launch's trailing scalars, after (batch, H, W)."""
    return (float(dx), -float(dt) / float(dx), float(dt),
            float(dt) * float(buoyancy), int(bool(buoyancy)), int(max_shift),
            int(closed), float(tol), int(maxiter))


def fused_step_forward(vy, vx, rho, acc_y, acc_x, fluid, fy=None, fx=None,
                       inflow=None, x0=None, *, dt: float, dx: float,
                       max_shift: int, buoyancy: float, closed: bool,
                       tol: float, maxiter: int):
    """K2: one fluid step per sample, one thread-block cluster per sample
    under `fwd_plan`. vy (B, H+1, W), vx (B, H, W+1), rho (B, H, W),
    optional fy/fx like vy/vx, inflow and x0 like rho, float32. Returns
    (vy4, vx4, rho1, p, trip counts (B,) int32)."""
    kw = dict(dt=dt, dx=dx, max_shift=max_shift, buoyancy=buoyancy,
              closed=closed, tol=tol, maxiter=maxiter)
    if cuda_cg._runs_plain(rho, "fused_step_forward"):
        return fused_step_plain_forward(vy, vx, rho, acc_y, acc_x, fluid, fy,
                                        fx, inflow, x0, **kw)
    return _launch_forward(vy, vx, rho, acc_y, acc_x, fluid, fy, fx, inflow,
                           x0, None, **kw)


def _launch_forward(vy, vx, rho, acc_y, acc_x, fluid, fy, fx, inflow, x0,
                    plan: cuda_cg.ClusterPlan | None, **kw):
    """Launches K2 on CUDA tensors under `plan` (None: `fwd_plan`'s). The
    tests pass other plans; a plan the launcher refuses raises."""
    global LAUNCHES_FWD
    if (fy is None) != (fx is None):
        raise ValueError("fy and fx go together")
    b, h, w = _check_cuda(vy, vx, rho, dict(fy=fy, fx=fx, inflow=inflow, x0=x0),
                          (acc_y, acc_x, fluid), int(kw["max_shift"]))
    if plan is None:
        plan = fwd_plan(b, h, w)
    qy, qx, inv_lam, qxt = cuda_cg._tables(h, w, float(kw["dx"]),
                                           bool(kw["closed"]), rho.device)
    vy4, vx4 = torch.empty_like(vy), torch.empty_like(vx)
    rho1, p = torch.empty_like(rho), torch.empty_like(rho)
    iters = torch.empty(b, dtype=torch.int32, device=rho.device)
    # The banded layout's residual and scaled spectrum, whole, a sample.
    scratch = (torch.empty((b, 2, h, w), dtype=torch.float32, device=rho.device)
               if fwd_layout(h, w) == cuda_cg.BANDED else None)
    rc = _kernels()[0](
        *map(_ptr, (vy, vx, rho, fy, fx, inflow, x0, acc_y, acc_x, fluid, qy,
                    qx, qxt, inv_lam, scratch, vy4, vx4, rho1, p, iters)),
        b, h, w, *_statics(**kw), plan.cluster, plan.threads,
        torch.cuda.current_stream(rho.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_step_fwd_f32 launch failed with cudaError "
                           f"{rc} under {plan}")
    LAUNCHES_FWD += 1
    return vy4, vx4, rho1, p, iters


def fused_step_backward(vy, vx, rho, g_vy4, g_vx4, g_rho1, g_p, acc_y, acc_x,
                        fluid, *, dt: float, dx: float, max_shift: int,
                        buoyancy: float, closed: bool, tol: float,
                        maxiter: int, has_force: bool, has_inflow: bool):
    """K3: the VJP of K2 from its inputs and the cotangents of (vy4, vx4,
    rho1, p), one thread-block cluster per sample under `bwd_plan`. Returns
    the cotangents of (vy, vx, rho, fy, fx, inflow), None for an operand the
    step did not take, and the transpose solve's trip counts (B,) int32."""
    kw = dict(dt=dt, dx=dx, max_shift=max_shift, buoyancy=buoyancy,
              closed=closed, tol=tol, maxiter=maxiter)
    if cuda_cg._runs_plain(rho, "fused_step_backward"):
        return fused_step_plain_backward(
            vy, vx, rho, g_vy4, g_vx4, g_rho1, g_p, acc_y, acc_x, fluid,
            has_force=has_force, has_inflow=has_inflow, **kw)
    return _launch_backward(vy, vx, rho, g_vy4, g_vx4, g_rho1, g_p, acc_y,
                            acc_x, fluid, None, has_force=has_force,
                            has_inflow=has_inflow, **kw)


def _launch_backward(vy, vx, rho, g_vy4, g_vx4, g_rho1, g_p, acc_y, acc_x,
                     fluid, plan: cuda_cg.ClusterPlan | None, *,
                     has_force: bool, has_inflow: bool, **kw):
    """Launches K3 on CUDA tensors under `plan` (None: `bwd_plan`'s). The
    tests and `sweep_dw_plan.py bwd` pass other plans; a plan the launcher
    refuses raises."""
    global LAUNCHES_BWD
    k = int(kw["max_shift"])
    b, h, w = _check_cuda(
        vy, vx, rho, dict(g_vy4=g_vy4, g_vx4=g_vx4, g_rho1=g_rho1, g_p=g_p),
        (acc_y, acc_x, fluid), k)
    if plan is None:
        plan = bwd_plan(b, h, w, k)
    qy, qx, inv_lam, qxt = cuda_cg._tables(h, w, float(kw["dx"]),
                                           bool(kw["closed"]), rho.device)
    g_vy, g_vx, g_rho = (torch.empty_like(t) for t in (vy, vx, rho))
    g_fy = torch.empty_like(vy) if has_force else None
    g_fx = torch.empty_like(vx) if has_force else None
    g_inflow = torch.empty_like(rho) if has_inflow else None
    iters = torch.empty(b, dtype=torch.int32, device=rho.device)
    # The banded layout's solve fields and each rank's window phase.
    scratch = (torch.empty((b, bwd_scratch_floats(h, w, plan.cluster, k)),
                           dtype=torch.float32, device=rho.device)
               if bwd_layout(h, w, k) == cuda_cg.BANDED else None)
    rc = _kernels()[1](
        *map(_ptr, (vy, vx, rho, g_vy4, g_vx4, g_rho1, g_p, acc_y, acc_x,
                    fluid, qy, qx, qxt, inv_lam, scratch, g_vy, g_vx, g_rho,
                    g_fy, g_fx, g_inflow, iters)),
        b, h, w, *_statics(**kw), plan.cluster, plan.threads,
        torch.cuda.current_stream(rho.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_step_bwd_f32 launch failed with cudaError "
                           f"{rc} under {plan}")
    LAUNCHES_BWD += 1
    return g_vy, g_vx, g_rho, g_fy, g_fx, g_inflow, iters


class _FusedStep(torch.autograd.Function):
    """(vy, vx, rho, fy, fx, inflow) → (vy4, vx4, rho1, p) by K2; backward
    by K3. Saves only the step's inputs, as the JAX custom VJP does. x0 and
    the geometry get no gradient (the converged pressure does not depend on
    the warm start).

    No remat: the JAX package names the outputs for its remat policy so
    that a rematerialised scan body does not re-run the kernel. Eager
    autograd saves the inputs once and never re-runs K2, so a step costs
    one forward and one transpose solve."""

    @staticmethod
    def forward(ctx, vy, vx, rho, fy, fx, inflow, x0, acc_y, acc_x, fluid, kw):
        ctx.kw = kw
        ctx.has_force = fy is not None
        ctx.has_inflow = inflow is not None
        ctx.save_for_backward(vy, vx, rho, acc_y, acc_x, fluid)
        return fused_step_forward(vy, vx, rho, acc_y, acc_x, fluid, fy, fx,
                                  inflow, x0, **kw)[:4]

    @staticmethod
    @once_differentiable
    def backward(ctx, g_vy4, g_vx4, g_rho1, g_p):
        vy, vx, rho, acc_y, acc_x, fluid = ctx.saved_tensors
        cots = [torch.zeros_like(ref) if g is None else g.contiguous()
                for g, ref in zip((g_vy4, g_vx4, g_rho1, g_p),
                                  (vy, vx, rho, rho))]
        grads = fused_step_backward(vy, vx, rho, *cots, acc_y, acc_x, fluid,
                                    has_force=ctx.has_force,
                                    has_inflow=ctx.has_inflow, **ctx.kw)
        return (*grads[:6], None, None, None, None, None)


def fused_fluid_step(vy, vx, rho, acc_y, acc_x, fluid, fy=None, fx=None,
                     inflow=None, x0=None, *, dt: float, dx: float,
                     max_shift: int, buoyancy: float, closed: bool,
                     tol: float, maxiter: int):
    """One fused fluid step, differentiable with respect to vy, vx, rho,
    fy, fx and inflow. The operands are made contiguous; x0 warm-starts
    the solve and is detached. Returns (vy', vx', rho', p)."""
    kw = dict(dt=float(dt), dx=float(dx), max_shift=int(max_shift),
              buoyancy=float(buoyancy), closed=bool(closed), tol=float(tol),
              maxiter=int(maxiter))

    def c(t):
        return None if t is None else t.contiguous()

    return _FusedStep.apply(c(vy), c(vx), c(rho), c(fy), c(fx), c(inflow),
                            None if x0 is None else c(x0.detach()), acc_y,
                            acc_x, fluid, kw)
