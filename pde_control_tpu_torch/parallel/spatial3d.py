"""3D spatial domain decomposition: one volume split along z over ranks.

Counterpart of `pde_control_tpu/parallel/spatial3d.py`, on the layout and
the collectives of `spatial.py` (the 2D split): one process per rank of a
(`data`, `space`) mesh, each holding its shard of the batch × its slab of
D/R cell planes. The MAC layout's D+1 z-faces are held in the lower-face
representation: a rank owns its cell planes and each cell's lower z-face,
and the one global top face is replicated on every rank as the last plane
of its vz block, so a vz block is (B/D, D/R + 1, H, W) (zero after
projection on the closed domains this path supports); vy (B, D, H+1, W)
and vx (B, D, H, W+1) split cleanly along D. `spatial_shard` /
`spatial_gather` (with `ndim=3`) convert between global tensors and a
rank's blocks.

Halo planes move between neighbouring ranks by `batch_isend_irecv` in
`spatial._Exchange` (k below and k+1 above for the shift advection
window, one plane for the stencils); the pressure solve's sums are
all-reduces over the space group, its CG is `spatial._SlabOps.cg_solve`
(as many trips on every rank), and the distributed 3D DCT does its x and
y products locally and its z products as partials reduce-scattered over
the space group: two reduce-scatters of the field per apply. The solve is
differentiated implicitly (`spatial._LinearSolve`). Every rank builds the
same autograd graph; a rank's position enters as a flag tensor in
`torch.where`.

Scope as in the JAX package: closed domains, viscosity 0, shift
advection; pressure backends 'auto' (→ 'spectral' without obstacles,
'pcg' with them), 'spectral', 'pcg' and 'jax' ('pcg2' is 2D only). No
hand-written kernel runs here: the kernels are single-device and 2D.
"""

from __future__ import annotations

import torch

from pde_control_tpu_torch.grids3d import (
    Domain3D,
    Staggered3D,
    centered_to_x_faces_3d,
    centered_to_y_faces_3d,
)
from pde_control_tpu_torch.ops.spectral import (
    _dct_matrix,
    _inv_neumann_eigenvalues_3d,
    _on_device,
)
from pde_control_tpu_torch.parallel.spatial import (
    SPACE_AXIS,
    Mesh2D,
    _abs,
    _check_mode,
    _edge,
    _exchange,
    _face_above,
    _flag,
    _halos_cell,
    _LinearSolve,
    _ReduceScatter,
    _SlabOps,
    make_mesh2d,
)
from pde_control_tpu_torch.physics.fluid3d import Fluid3DConfig, FluidState3D

__all__ = ["make_mesh2d", "spatial_fluid3d_step",
           "spatial_pressure_solve3d_diag"]


def _sample_shift_local3d(field, disp_z, disp_y, disp_x, k, below, above):
    """`shift_trilinear_sample_3d` on a slab extended by halo planes, in
    the tie form of `spatial._sample_shift_local` (the JAX package's
    plain jnp code, so that autograd is JAX's at the ties).

    field: (B, Zk, H', W'); below: (B, k, H', W') planes under the slab;
    above: (B, k+1, H', W') planes over it (the window's offsets
    −k..k+1). The y and x axes are whole on every rank: edge padded
    (replicate, whose gradient sums into the edge as `jnp.pad`'s)."""
    zk, h, w = field.shape[1:]
    lo, hi = field.new_tensor(-float(k)), field.new_tensor(float(k))
    zero = field.new_tensor(0.0)
    disp_z, disp_y, disp_x = (torch.minimum(torch.maximum(d, lo), hi)
                              for d in (disp_z, disp_y, disp_x))
    ext = torch.nn.functional.pad(torch.cat([below, field, above], dim=1),
                                  (k, k + 1, k, k + 1), mode="replicate")
    offsets = range(-k, k + 2)
    wy = [torch.maximum(zero, 1.0 - _abs(disp_y - o)) for o in offsets]
    wx = [torch.maximum(zero, 1.0 - _abs(disp_x - o)) for o in offsets]
    out = torch.zeros_like(field)
    for oz in offsets:
        wz = torch.maximum(zero, 1.0 - _abs(disp_z - oz))
        plane = ext[:, k + oz:k + oz + zk]
        for iy, oy in enumerate(offsets):
            wzy = wz * wy[iy]
            row = plane[:, :, k + oy:k + oy + h]
            for ix, ox in enumerate(offsets):
                val = row[:, :, :, k + ox:k + ox + w]
                out = out + val * (wzy * wx[ix])
    return out


class _PressureOps3D(_SlabOps):
    """The distributed 3D pressure-solve operators over one rank's z-slab
    (`pde_control_tpu/parallel/spatial3d.py :: _PressureOps3D`): the gated
    operator and the distributed exact 3D DCT solve; the deflation, the
    preconditioner and the CG are `_SlabOps`'."""

    def __init__(self, mesh, fluid, acc_z_lo, acc_above, acc_y, acc_x, *,
                 dx, tol, maxiter, mode, qz, qy, qx, inv_lam):
        super().__init__(mesh, fluid, dx=dx, tol=tol, maxiter=maxiter,
                         mode=mode)
        self.acc_z_lo, self.acc_above = acc_z_lo, acc_above
        self.acc_y, self.acc_x = acc_y, acc_x
        self.qz, self.qy, self.qx, self.inv_lam = qz, qy, qx, inv_lam

    def grad_p(self, p):
        """Gated ∇p: (gz_lo, gz_hi, gy, gx); gz_hi is the slab's top
        z-face plane, which the divergence needs."""
        dx = self.dx
        p_prev, p_next = _exchange(p, 1, 1, self.mesh)  # gated at the ends
        pm = torch.cat([p_prev, p[:, :-1]], dim=1)
        gz_lo = (p - pm) / dx * self.acc_z_lo
        gz_hi = (p_next - p[:, -1:]) / dx * self.acc_above
        pyp = torch.nn.functional.pad(p, (0, 0, 1, 1))
        gy = (pyp[:, :, 1:] - pyp[:, :, :-1]) / dx * self.acc_y
        pxp = torch.nn.functional.pad(p, (1, 1))
        gx = (pxp[..., 1:] - pxp[..., :-1]) / dx * self.acc_x
        return gz_lo, gz_hi, gy, gx

    def matvec_raw(self, p):
        gz_lo, gz_hi, gy, gx = self.grad_p(p)
        lap = (torch.cat([gz_lo[:, 1:], gz_hi], dim=1) - gz_lo
               + gy[:, :, 1:] - gy[:, :, :-1]
               + gx[..., 1:] - gx[..., :-1]) / self.dx
        return torch.where(self.fluid > 0, -lap, p)

    def dist_spectral(self, rhs):
        """The global 3D DCT-II Neumann pseudo-inverse applied to a slab
        (B, Zk, H, W), in fp32: the x and y products are local; the
        forward z product is a partial over the slab's planes,
        reduce-scattered over the y-mode axis; the eigenvalues multiply
        this rank's H/R block of y-modes; the inverse z product is local;
        the inverse y product is a partial over that block,
        reduce-scattered over z back to the slab; the inverse x product is
        local."""
        qz, qy, qx, idx, mesh = self.qz, self.qy, self.qx, self.idx, self.mesh
        zk, mk = rhs.shape[1], qy.shape[0] // self.r
        c = torch.einsum("lw,bdhw->bdhl", qx, rhs)
        c = torch.einsum("mh,bdhl->bdml", qy, c)
        part = torch.einsum("zd,bdml->bzml", qz[:, idx * zk:(idx + 1) * zk], c)
        spec = _ReduceScatter.apply(part, 2, mesh)         # (B, D, H/R, W)
        spec = spec * self.inv_lam[None, :, idx * mk:(idx + 1) * mk]
        sp = torch.einsum("zd,bzml->bdml", qz, spec)
        part2 = torch.einsum("mh,bdml->bdhl", qy[idx * mk:(idx + 1) * mk], sp)
        out = _ReduceScatter.apply(part2, 1, mesh)         # (B, Zk, H, W)
        return torch.einsum("lw,bdhl->bdhw", qx, out)


def _spectral_tables3d(mode: str, domain: Domain3D, device):
    if mode == "jax":
        return None, None, None, None
    d, h, w = domain.grid_shape
    return (*(_on_device(_dct_matrix, (n,), device) for n in (d, h, w)),
            _on_device(_inv_neumann_eigenvalues_3d, (d, h, w,
                                                     float(domain.dx)),
                       device))


def _slab_ops(domain: Domain3D, mesh: Mesh2D, mode: str, tol: float,
              maxiter: int, device) -> _PressureOps3D:
    """This rank's pressure operators: its slab of the global masks, the
    face above its slab (the next slab's first, or the global top face)."""
    planes = mesh.row_slice(domain.grid_shape[0])
    qz, qy, qx, inv_lam = _spectral_tables3d(mode, domain, device)
    return _PressureOps3D(
        mesh, domain.fluid_mask[planes], domain.acc_z[planes],
        domain.acc_z[planes.stop:planes.stop + 1], domain.acc_y[planes],
        domain.acc_x[planes], dx=domain.dx, tol=tol, maxiter=maxiter,
        mode=mode, qz=qz, qy=qy, qx=qx, inv_lam=inv_lam)


def spatial_fluid3d_step(
    state: FluidState3D,
    domain: Domain3D,
    cfg: Fluid3DConfig,
    mesh: Mesh2D,
    force: Staggered3D | None = None,
    buoyancy_factor: torch.Tensor | None = None,
) -> FluidState3D:
    """One `fluid3d_step` on this rank's blocks (`spatial_shard(...,
    ndim=3)` of the global state and force), for the closed, inviscid,
    shift-advected scope. `domain` is the global domain.
    `buoyancy_factor`: this rank's (B/D, 1, 1, 1) rows, replicated over
    the space group (its gradient is then this rank's part, which the
    caller sums over the space group), or its (B/D, D/R, H, W) block of a
    full centered field. Pressure backends as the JAX package's: 'auto'
    → 'spectral' without obstacles and 'pcg' with them; 'jax'. Returns
    this rank's blocks of the next state (vz's replicated top face is
    zero)."""
    mode = _check_mode(domain, cfg, "spatial_fluid3d_step",
                       ("spectral", "pcg", "jax"))
    r = mesh.shape[SPACE_AXIS]
    d, h, _ = domain.grid_shape
    k = int(cfg.max_shift)
    if d % r:
        raise ValueError(f"D={d} not divisible by space axis size {r}")
    if mode != "jax" and h % r:
        raise ValueError(f"H={h} not divisible by space axis size {r} "
                         "(the distributed 3D spectral transform reduce-"
                         "scatters along the y-mode axis); use "
                         "pressure_backend='jax'")
    if d // r < k + 2:
        raise ValueError(f"slab of {d // r} planes < max_shift+2={k + 2}; "
                         "use fewer space shards or a deeper grid")
    dt, dx = cfg.dt, domain.dx
    dev = state.density.device
    ops = _slab_ops(domain, mesh, mode, cfg.pressure_tol,
                    cfg.pressure_maxiter, dev)
    first, top = _flag(mesh.space_index == 0, dev), _flag(
        mesh.space_index == r - 1, dev)

    vz_lo, vz_top = state.velocity.vz[:, :-1], state.velocity.vz[:, -1:]
    vy, vx, density = state.velocity.vy, state.velocity.vx, state.density
    inflow = state.inflow
    if inflow is not None and inflow.dim() == 3:
        inflow = inflow.expand(density.shape)
    buoy = buoyancy_factor
    buoy_full = (buoy is not None and buoy.dim() >= 4
                 and buoy.shape[1] == density.shape[1])

    def prev_cell(c):
        """The plane under the slab's first; its own at the global
        bottom (the dense path's edge clamp)."""
        return torch.where(first, c[:, :1], _exchange(c, 1, 0, mesh)[0])

    def to_z_faces(c):
        """Centered → lower z-faces: 0.5·(c[k−1] + c[k])."""
        return 0.5 * (torch.cat([prev_cell(c), c[:, :-1]], dim=1) + c)

    # --- advection (density, then velocity, as fluid3d_step) -------------
    vz_above1 = _face_above(_exchange(vz_lo, 0, 1, mesh)[1], vz_top, 1, top)
    vz_c = 0.5 * (vz_lo + torch.cat([vz_lo[:, 1:], vz_above1], dim=1))
    vy_c = 0.5 * (vy[:, :, :-1] + vy[:, :, 1:])
    vx_c = 0.5 * (vx[..., :-1] + vx[..., 1:])
    s = -dt / dx

    d_below, d_above = _halos_cell(density, k, k + 1, mesh, first, top)
    density_new = _sample_shift_local3d(
        density, s * vz_c, s * vy_c, s * vx_c, k, d_below, d_above)
    if inflow is not None:
        density_new = density_new + dt * inflow

    # vz at z-faces: native vz; vy/vx centers resampled to the z-faces.
    vy_at_z, vx_at_z = to_z_faces(vy_c), to_z_faces(vx_c)
    vz_below, vz_next = _exchange(vz_lo, k, k + 1, mesh)
    vz_below = torch.where(first, _edge(vz_lo, 0, k), vz_below)
    vz_above = _face_above(vz_next, vz_top, k + 1, top)
    vz_new = _sample_shift_local3d(
        vz_lo, s * vz_lo, s * vy_at_z, s * vx_at_z, k, vz_below, vz_above)

    # vy at y-faces and vx at x-faces: the others' centers resampled
    # along the unsplit axis (local, as the dense step).
    vy_below, vy_above = _halos_cell(vy, k, k + 1, mesh, first, top)
    vy_new = _sample_shift_local3d(
        vy, s * centered_to_y_faces_3d(vz_c), s * vy,
        s * centered_to_y_faces_3d(vx_c), k, vy_below, vy_above)
    vx_below, vx_above = _halos_cell(vx, k, k + 1, mesh, first, top)
    vx_new = _sample_shift_local3d(
        vx, s * centered_to_x_faces_3d(vz_c),
        s * centered_to_x_faces_3d(vy_c), s * vx, k, vx_below, vx_above)

    # --- forces and buoyancy (on the advected density) --------------------
    # The force's global top z-face is dropped with the velocity's: the
    # dense step's projection masks that wall face to zero.
    if force is not None:
        vz_new = vz_new + dt * force.vz[:, :-1]
        vy_new = vy_new + dt * force.vy
        vx_new = vx_new + dt * force.vx
    if buoy_full:
        # Weight the density at the centers, then resample to z-faces.
        vz_new = vz_new + dt * to_z_faces(buoy * density_new)
    elif buoy is not None or cfg.buoyancy:
        b = cfg.buoyancy if buoy is None else buoy
        vz_new = vz_new + dt * b * to_z_faces(density_new)

    # --- projection: mask, divergence, solve, correct ---------------------
    vz_m, vy_m, vx_m = (vz_new * ops.acc_z_lo, vy_new * ops.acc_y,
                        vx_new * ops.acc_x)
    vz_m_above = _face_above(_exchange(vz_m, 0, 1, mesh)[1],
                             torch.zeros_like(vz_top), 1, top)
    div = (torch.cat([vz_m[:, 1:], vz_m_above], dim=1) - vz_m
           + vy_m[:, :, 1:] - vy_m[:, :, :-1]
           + vx_m[..., 1:] - vx_m[..., :-1]) / dx

    rhs = torch.where(ops.fluid > 0, -div, 0.0)
    x0 = state.pressure
    guess = None if (x0 is None or mode == "spectral") else x0.detach()
    p = _LinearSolve.apply(rhs, ops.make_solve(guess), ops.make_solve(None))

    gz_lo, _, gy, gx = ops.grad_p(p)
    vz2 = torch.cat([vz_m - gz_lo, torch.zeros_like(vz_top)], dim=1)
    return FluidState3D(
        velocity=Staggered3D(vz=vz2, vy=vy_m - gy, vx=vx_m - gx),
        density=density_new, inflow=state.inflow,
        pressure=p if state.pressure is not None else None)


def spatial_pressure_solve3d_diag(
    div: torch.Tensor,
    domain: Domain3D,
    mesh: Mesh2D,
    mode: str = "pcg",
    tol: float = 1e-5,
    maxiter: int = 500,
):
    """The distributed 3D pressure solve of the step outside its autograd
    Function, so that the trip count comes out: returns (this rank's
    pressure block, trips). div: this rank's (B/D, D/R, H, W) block.
    mode: 'jax' | 'pcg' | 'spectral' (exact, obstacle-free; 0 trips)."""
    if mode == "spectral" and domain.has_obstacles:
        raise ValueError("'spectral' is exact only without obstacles")
    r = mesh.shape[SPACE_AXIS]
    d, h, w = domain.grid_shape
    if d % r or (mode != "jax" and h % r):
        raise ValueError(f"grid {d}x{h}x{w} not divisible by space={r}")
    with torch.no_grad():
        ops = _slab_ops(domain, mesh, mode, tol, maxiter, div.device)
        rhs = ops.project(torch.where(ops.fluid > 0, -div, 0.0))
        if mode == "spectral":
            return ops.project(ops.dist_spectral(rhs)), 0
        return ops.cg_solve(rhs, None)
