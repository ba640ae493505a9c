"""Spatial domain decomposition: one 2D grid split along H over ranks.

Counterpart of `pde_control_tpu/parallel/spatial.py`, with the same math
and its layout made explicit. The JAX package runs the step under
`shard_map` over a ('data', 'space') device mesh; here each rank is a
process (`make_mesh2d`: a world of n_data × n_space ranks, row-major, one
space group per data row and one data group per space column) that holds
its blocks: its shard of the batch × its slab of H/R cell rows. The MAC
layout's H+1 face rows are held in the lower-face representation: a rank
owns its cell rows and each cell's lower y-face, and the one global top
face is replicated on every rank as the last row of its vy block, so a vy
block is (B/D, H/R + 1, W) on every rank (zero after projection on the
closed domains this path supports). `spatial_shard` / `spatial_gather`
convert between global tensors and a rank's blocks.

Halo rows move between neighbouring ranks by `batch_isend_irecv` on the
space group, in one autograd Function whose backward sends each halo's
gradient back to the rank that owns the rows; k+1 rows for the
CFL-bounded shift advection window, one row for the stencils. The pressure
solve's inner products and nullspace projection are all-reduces over the
space group; the distributed DCT reduce-scatters its partial products
(`reduce_scatter_tensor`, backward `all_gather_into_tensor`); the CG runs
as many trips on every rank (each trip all-reduces the active flag with
MAX over the whole world and reads it on the host: the collectives
deadlock otherwise). The solve is differentiated implicitly, as
`lax.custom_linear_solve(symmetric=True)` does: the backward pass is a
cold solve of the gradient with the same distributed operator.

`spatial3d.py` splits a volume along z on the same pieces: the shard and
gather (`ndim=3`), the halo Function, the reduce-scatter and the solve's
shared part (`_SlabOps`: the deflation, the preconditioner and the CG).

Every rank builds the same autograd graph, op for op (a rank's position
enters as a flag tensor in `torch.where`, never as a branch), so that the
backward passes run their collectives in the same order on every rank.

Scope as in the JAX package: closed domains, viscosity 0, shift
advection; pressure backends 'auto' (→ 'spectral' without obstacles,
'pcg' with them), 'spectral' (the exact distributed DCT solve), 'pcg'
(CG preconditioned by it), 'pcg2' (plus a Galerkin coarse space) and
'jax' (plain distributed CG). No hand-written kernel runs here: the
kernels are single-device, and 'pallas' (the JAX package's) is refused.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from pde_control_tpu_torch.grids import Domain2D, Staggered2D
from pde_control_tpu_torch.grids3d import Staggered3D
from pde_control_tpu_torch.ops.spectral import (
    _dct_matrix,
    _inv_neumann_eigenvalues,
    _on_device,
)
from pde_control_tpu_torch.parallel.mesh import Mesh, make_mesh
from pde_control_tpu_torch.physics.fluid import FluidConfig, FluidState

DATA_AXIS = "data"
SPACE_AXIS = "space"


@dataclasses.dataclass(frozen=True)
class Mesh2D(Mesh):
    """A ('data', 'space') mesh: this rank's indices along both axes and
    the groups of its data row (`space_group`, the ranks that split one
    grid) and of its space column (`data_group`)."""

    data_index: int = 0
    space_index: int = 0
    space_group: object = None
    data_group: object = None

    def batch_slice(self, b: int) -> slice:
        """This rank's rows of a global batch of `b`."""
        k = b // self.shape[DATA_AXIS]
        return slice(self.data_index * k, (self.data_index + 1) * k)

    def row_slice(self, h: int) -> slice:
        """This rank's cell rows of a grid of `h` rows."""
        k = h // self.shape[SPACE_AXIS]
        return slice(self.space_index * k, (self.space_index + 1) * k)


def make_mesh2d(n_data: int, n_space: int, device=None) -> Mesh2D:
    """A (n_data, n_space) mesh over the default process group, laid out
    row-major as the JAX package reshapes its devices: rank d·n_space + s
    holds data shard d and slab s. Every rank creates every group. The
    world is `make_mesh`'s of n_data·n_space ranks (started from torchrun's
    environment when it is not yet; a world of another size raises)."""
    base = make_mesh(n_data * n_space, device=device)
    space_groups = [dist.new_group([d * n_space + s for s in range(n_space)])
                    for d in range(n_data)]
    data_groups = [dist.new_group([d * n_space + s for d in range(n_data)])
                   for s in range(n_space)]
    d, s = divmod(base.rank, n_space)
    return Mesh2D((DATA_AXIS, SPACE_AXIS), {DATA_AXIS: n_data,
                                            SPACE_AXIS: n_space},
                  base.rank, base.device, base.backend, d, s,
                  space_groups[d], data_groups[s])


def spatial_spec(rank: int, ndim: int) -> tuple:
    """The mesh axis of each array axis (the JAX package's PartitionSpec,
    as a tuple): a batched field (B, H, W) / (B, D, H, W) splits its batch
    over 'data' and its first spatial axis over 'space'; an unbatched mask
    (H, W) / (D, H, W) its first axis over 'space'; anything else is
    replicated. `ndim`: the problem's spatial rank (2 or 3)."""
    if ndim not in (2, 3):
        raise ValueError(f"ndim must be 2 or 3, got {ndim}")
    if rank == ndim + 1:
        return (DATA_AXIS, SPACE_AXIS) + (None,) * (rank - 2)
    if rank == ndim:
        return (SPACE_AXIS,) + (None,) * (rank - 1)
    return ()


def _take(x: torch.Tensor, axis: int, part: int, parts: int) -> torch.Tensor:
    n = x.shape[axis]
    if n % parts:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} not divisible "
                         f"by {parts}")
    k = n // parts
    return x.narrow(axis, part * k, k)


def _gather(x: torch.Tensor, axis: int, group, parts: int) -> torch.Tensor:
    """Concatenation of the group's blocks along `axis`
    (`all_gather_into_tensor` along the leading axis)."""
    xs = x.movedim(axis, 0).contiguous()
    out = xs.new_empty((parts * xs.shape[0],) + xs.shape[1:])
    dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, axis)


def _map(fn_tensor, fn_staggered, tree):
    if tree is None:
        return None
    if isinstance(tree, (Staggered2D, Staggered3D)):
        return fn_staggered(tree)
    if isinstance(tree, torch.Tensor):
        return fn_tensor(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn_tensor, fn_staggered, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn_tensor, fn_staggered, v) for k, v in tree.items()}
    return tree


def _faces(v) -> tuple[list[str], int]:
    """The component names of a `Staggered2D` / `Staggered3D`, the one with
    the +1 along the split axis first, and the axis of its batch."""
    names = [f.name for f in dataclasses.fields(v)]
    return names, getattr(v, names[0]).dim() - len(names) - 1


def spatial_shard(tree, mesh: Mesh2D, ndim: int = 2):
    """This rank's blocks of a tree of global tensors (a tensor, a
    `Staggered2D` / `Staggered3D`, a dataclass such as `FluidState`, or a
    dict of them). A tensor is split per `spatial_spec`; a staggered
    velocity, with any leading axes before B, is split along B and its
    first spatial axis into the lower-face representation: the block of
    the component with the extra face along that axis (vy (B, H+1, W) in
    2D, vz (B, D+1, H, W) in 3D) keeps the global top face as its last
    row or plane; the other components split cleanly."""
    nd, ns = mesh.shape[DATA_AXIS], mesh.shape[SPACE_AXIS]
    d, s = mesh.data_index, mesh.space_index

    def tensor(x):
        out = x
        for axis, name in enumerate(spatial_spec(x.dim(), ndim)):
            if name == DATA_AXIS:
                out = _take(out, axis, d, nd)
            elif name == SPACE_AXIS:
                out = _take(out, axis, s, ns)
        return out.contiguous()

    def staggered(v):
        names, b_axis = _faces(v)
        f = _take(getattr(v, names[0]), b_axis, d, nd)
        top = f.narrow(b_axis + 1, f.shape[b_axis + 1] - 1, 1)
        lo = _take(f.narrow(b_axis + 1, 0, f.shape[b_axis + 1] - 1),
                   b_axis + 1, s, ns)
        rest = {n: _take(_take(getattr(v, n), b_axis, d, nd), b_axis + 1, s,
                         ns).contiguous() for n in names[1:]}
        return type(v)(**{names[0]: torch.cat([lo, top], dim=b_axis + 1)},
                       **rest)

    return _map(tensor, staggered, tree)


def spatial_gather(tree, mesh: Mesh2D, ndim: int = 2, grad: bool = False):
    """The global tensors of a tree of this rank's blocks (the inverse of
    `spatial_shard`), on every rank. With `grad`, the tree holds
    gradients: the replicated top face of a staggered block is then summed
    over the space group (each rank holds its part of its gradient)."""
    nd, ns = mesh.shape[DATA_AXIS], mesh.shape[SPACE_AXIS]

    def tensor(x):
        out = x
        for axis, name in enumerate(spatial_spec(x.dim(), ndim)):
            if name == DATA_AXIS:
                out = _gather(out, axis, mesh.data_group, nd)
            elif name == SPACE_AXIS:
                out = _gather(out, axis, mesh.space_group, ns)
        return out

    def staggered(v):
        names, b_axis = _faces(v)
        f = getattr(v, names[0])
        rows = f.shape[b_axis + 1]
        top = f.narrow(b_axis + 1, rows - 1, 1).contiguous()
        if grad:
            dist.all_reduce(top, group=mesh.space_group)
        lo = _gather(f.narrow(b_axis + 1, 0, rows - 1), b_axis + 1,
                     mesh.space_group, ns)
        faced = _gather(torch.cat([lo, top], dim=b_axis + 1), b_axis,
                        mesh.data_group, nd)
        rest = {n: _gather(_gather(getattr(v, n), b_axis + 1,
                                   mesh.space_group, ns), b_axis,
                           mesh.data_group, nd) for n in names[1:]}
        return type(v)(**{names[0]: faced}, **rest)

    return _map(tensor, staggered, tree)


# ---------------------------------------------------------------------------
# Communication with autograd.
# ---------------------------------------------------------------------------


def _swap(to_next, to_prev, from_prev_rows: int, from_next_rows: int,
          like: torch.Tensor, mesh: Mesh2D):
    """Sends `to_next` to the next rank of the space group and `to_prev`
    to the previous one, and returns (the previous rank's `to_next`, the
    next rank's `to_prev`), of `from_prev_rows` and `from_next_rows` rows;
    zeros where there is no neighbour. Blocks are (B, rows, *rest): rows
    of a grid or planes of a volume."""
    b, _, *rest = like.shape
    from_prev = like.new_zeros((b, from_prev_rows, *rest))
    from_next = like.new_zeros((b, from_next_rows, *rest))
    idx, r = mesh.space_index, mesh.shape[SPACE_AXIS]
    ops = []
    if idx > 0:
        if to_prev is not None:
            ops.append(dist.P2POp(dist.isend, to_prev.contiguous(),
                                  mesh.rank - 1, mesh.space_group))
        if from_prev_rows:
            ops.append(dist.P2POp(dist.irecv, from_prev, mesh.rank - 1,
                                  mesh.space_group))
    if idx < r - 1:
        if to_next is not None:
            ops.append(dist.P2POp(dist.isend, to_next.contiguous(),
                                  mesh.rank + 1, mesh.space_group))
        if from_next_rows:
            ops.append(dist.P2POp(dist.irecv, from_next, mesh.rank + 1,
                                  mesh.space_group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return from_prev, from_next


class _Exchange(torch.autograd.Function):
    """(below, above) = the previous rank's trailing `lo` rows of x and
    the next rank's leading `hi` rows, zeros without a neighbour (the JAX
    package's `_pperm_from_prev` and `_pperm_from_next` in one exchange).
    The backward pass sends each halo's gradient back to the rank that
    owns the rows, which adds it to its own: the next rank's gradient of
    its `below` lands on x's trailing `lo` rows, the previous rank's
    gradient of its `above` on the leading `hi` rows."""

    @staticmethod
    def forward(ctx, x, lo: int, hi: int, mesh: Mesh2D):
        ctx.lo, ctx.hi, ctx.mesh, ctx.shape = lo, hi, mesh, x.shape
        return _swap(x[:, x.shape[1] - lo:] if lo else None,
                     x[:, :hi] if hi else None, lo, hi, x, mesh)

    @staticmethod
    def backward(ctx, g_below, g_above):
        lo, hi, mesh = ctx.lo, ctx.hi, ctx.mesh
        b, rows, *rest = ctx.shape
        like = g_below if g_below is not None else g_above
        if g_below is None:
            g_below = like.new_zeros((b, lo, *rest))
        if g_above is None:
            g_above = like.new_zeros((b, hi, *rest))
        from_prev, from_next = _swap(g_above if hi else None,
                                     g_below if lo else None, hi, lo,
                                     g_below, mesh)
        gx = g_below.new_zeros((b, rows, *rest))
        if hi:
            gx[:, :hi] += from_prev
        if lo:
            gx[:, rows - lo:] += from_next
        return gx, None, None, None


class _ReduceScatter(torch.autograd.Function):
    """The sum over the space group of x, of which this rank keeps block
    `space_index` along `axis` (`lax.psum_scatter(tiled=True)`); the
    backward pass all-gathers the gradient."""

    @staticmethod
    def forward(ctx, x, axis: int, mesh: Mesh2D):
        ctx.axis, ctx.mesh = axis, mesh
        parts = mesh.shape[SPACE_AXIS]
        xs = x.movedim(axis, 0).contiguous()
        out = xs.new_empty((xs.shape[0] // parts,) + xs.shape[1:])
        dist.reduce_scatter_tensor(out, xs, group=mesh.space_group)
        return out.movedim(0, axis)

    @staticmethod
    def backward(ctx, g):
        return (_gather(g, ctx.axis, ctx.mesh.space_group,
                        ctx.mesh.shape[SPACE_AXIS]), None, None)


class _LinearSolve(torch.autograd.Function):
    """p = solve(rhs), differentiated as `lax.custom_linear_solve(...,
    symmetric=True)`: the gradient of rhs is `transpose_solve(g)`."""

    @staticmethod
    def forward(ctx, rhs, solve, transpose_solve):
        ctx.transpose_solve = transpose_solve
        return solve(rhs)

    @staticmethod
    def backward(ctx, g):
        with torch.no_grad():
            return ctx.transpose_solve(g.contiguous()), None, None


def _exchange(x: torch.Tensor, lo: int, hi: int, mesh: Mesh2D):
    return _Exchange.apply(x, lo, hi, mesh)


def _flag(value: bool, device) -> torch.Tensor:
    return torch.tensor(bool(value), device=device)


# ---------------------------------------------------------------------------
# The distributed pressure solve, on one rank's slab.
# ---------------------------------------------------------------------------


class _SlabOps:
    """What the distributed pressure solves share in 2D and 3D
    (`pde_control_tpu/parallel/spatial.py :: _PressureOps` and
    `spatial3d.py :: _PressureOps3D`): the all-reduces over the space
    group, the global-mean deflation projection, the deflated
    preconditioners (one-level, and two-level over a subclass's
    `coarse_q`) and a CG that also reports its trips, on a rank's slab
    (B, rows, ...) with every sum over its non-batch axes. A subclass
    gives the gated operator (`matvec_raw`) and the distributed exact
    solve (`dist_spectral`)."""

    def __init__(self, mesh, fluid, *, dx, tol, maxiter, mode):
        self.mesh, self.idx = mesh, mesh.space_index
        self.r, self.dx = mesh.shape[SPACE_AXIS], dx
        self.fluid = fluid
        self.tol, self.maxiter, self.mode = tol, maxiter, mode
        self.n_fluid = torch.clamp(self.psum(fluid.sum().reshape(1)), min=1.0)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.mesh.space_group)
        return t

    @staticmethod
    def _sum(x):
        """x summed over every non-batch axis, as (B, 1, ...)."""
        return torch.sum(x, dim=tuple(range(1, x.dim())), keepdim=True)

    def psum_dot(self, a, b):
        return self.psum(self._sum(a * b))

    def project(self, p):
        mean = self.psum(self._sum(p * self.fluid)) / self.n_fluid
        return torch.where(self.fluid > 0, p - mean, p)

    def matvec(self, p):
        return self.project(self.matvec_raw(self.project(p)))

    def precond(self, res):
        return self.project(self.dist_spectral(self.project(res)))

    def precond2(self, res):
        """A-DEF2 two-level apply: M₂⁻¹ = Pᵀ M⁻¹ + Q with P = I − A Q,
        inside the global-mean deflation."""
        res = self.project(res)
        y = self.project(self.dist_spectral(res))
        return self.project(y - self.coarse_q(self.matvec(y))
                            + self.coarse_q(res))

    def _any_active(self, act: torch.Tensor) -> bool:
        """Whether any sample of any rank is active: every rank runs the
        same trips, as the collectives need (a frozen sample's extra trips
        leave it as it was)."""
        flag = act.any().int().reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def cg_solve(self, rhs, guess):
        """Distributed (preconditioned) CG with the per-sample freeze and
        the best-iterate safeguard; returns (x_best, trips)."""
        matvec, psum_dot = self.matvec, self.psum_dot
        apply_m = {"pcg": self.precond, "pcg2": self.precond2}.get(
            self.mode, lambda res: res)
        x = torch.zeros_like(rhs) if guess is None else guess
        if self.mode == "pcg2":
            # The deflated start x₀ ← Q b + Pᵀ x₀ keeps A-DEF2 CG-robust.
            x = self.project(
                self.coarse_q(rhs) + x - self.coarse_q(matvec(x)))
        res = rhs - matvec(x)
        z = apply_m(res)
        d = z
        rz = psum_dot(res, z)
        rs = psum_dot(res, res)
        b2 = torch.clamp(psum_dot(rhs, rhs), min=1e-30)
        tol2 = self.tol * self.tol
        x_best, rs_best = x, rs

        def active(rs_i, rs_b):
            return (rs_i / b2 > tol2) & (rs_i < 4.0 * rs_b)

        i = 0
        flag = self._any_active(active(rs, rs_best))
        while i < self.maxiter and flag:
            act = active(rs, rs_best)
            ad = matvec(d)
            dad = psum_dot(d, ad)
            ok = act & (dad > 0)
            alpha = torch.where(ok, rz / torch.where(dad > 0, dad, 1.0), 0.0)
            x = x + alpha * d
            res = res - alpha * ad
            z = apply_m(res)
            rz_new = psum_dot(res, z)
            rs_new = psum_dot(res, res)
            beta = torch.where(ok, rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
            d = z + beta * d
            x_best = torch.where(rs_new < rs_best, x, x_best)
            rs_best = torch.minimum(rs_new, rs_best)
            rz, rs = rz_new, rs_new
            i += 1
            flag = self._any_active(active(rs, rs_best))
        return x_best, i

    def make_solve(self, guess):
        if self.mode == "spectral":
            # Exact: the closed obstacle-free operator is diagonal in the
            # DCT-II basis. The projection stays inside the solve (a
            # backward gradient carries a nullspace component).
            return lambda rhs: self.project(
                self.dist_spectral(self.project(rhs)))
        return lambda rhs: self.cg_solve(
            self.project(rhs),
            None if guess is None else self.project(guess))[0]


class _PressureOps(_SlabOps):
    """The distributed 2D pressure-solve operators over one rank's slab
    (`pde_control_tpu/parallel/spatial.py :: _PressureOps`): the gated
    operator, the distributed exact solve, and the 'pcg2' coarse space."""

    def __init__(self, mesh, fluid, acc_y_lo, acc_above, acc_x, *, w, dx,
                 tol, maxiter, mode, qh, qw, inv_lam, nbh=None, nbw=None):
        super().__init__(mesh, fluid, dx=dx, tol=tol, maxiter=maxiter,
                         mode=mode)
        self.w = w
        self.acc_y_lo, self.acc_above, self.acc_x = acc_y_lo, acc_above, acc_x
        self.qh, self.qw, self.inv_lam = qh, qw, inv_lam
        self.coarse_q = (self._coarse_setup(nbh, nbw) if mode == "pcg2"
                         else None)

    def grad_p(self, p):
        """Gated ∇p: (gy_lo, gy_hi, gx); gy_hi is the slab's top face row
        (face index Hk), which the divergence needs."""
        dx = self.dx
        p_prev, p_next = _exchange(p, 1, 1, self.mesh)  # gated at the ends
        pm = torch.cat([p_prev, p[:, :-1, :]], dim=1)
        gy_lo = (p - pm) / dx * self.acc_y_lo
        gy_hi = (p_next - p[:, -1:, :]) / dx * self.acc_above
        gxp = torch.nn.functional.pad(p, (1, 1))
        gx = (gxp[:, :, 1:] - gxp[:, :, :-1]) / dx * self.acc_x
        return gy_lo, gy_hi, gx

    def matvec_raw(self, p):
        gy_lo, gy_hi, gx = self.grad_p(p)
        lap = (torch.cat([gy_lo[:, 1:, :], gy_hi], dim=1) - gy_lo
               + gx[:, :, 1:] - gx[:, :, :-1]) / self.dx
        return torch.where(self.fluid > 0, -lap, p)

    def dist_spectral(self, rhs):
        """The global DCT-II Neumann pseudo-inverse applied to a slab
        (B, Hk, W), in fp32: the W-axis products are local, the H-axis
        forward product is a partial over the slab's rows reduce-scattered
        over W, the inverse W-axis product a partial over this rank's
        block of W frequencies reduce-scattered over H."""
        qh, qw, inv_lam, idx, mesh = (self.qh, self.qw, self.inv_lam,
                                      self.idx, self.mesh)
        hk, wk = rhs.shape[1], self.w // self.r
        c = torch.einsum("lw,bhw->bhl", qw, rhs)
        part = torch.einsum("kh,bhl->bkl", qh[:, idx * hk:(idx + 1) * hk], c)
        spec = _ReduceScatter.apply(part, 2, mesh)            # (B, H, W/r)
        spec = spec * inv_lam[None, :, idx * wk:(idx + 1) * wk]
        sp = torch.einsum("kh,bkl->bhl", qh, spec)
        part2 = torch.einsum("lw,bhl->bhw", qw[idx * wk:(idx + 1) * wk], sp)
        return _ReduceScatter.apply(part2, 1, mesh)           # (B, Hk, W)

    def _coarse_setup(self, nbh: int, nbw: int):
        """The Galerkin coarse operator E = Zᵀ A Z over fluid-masked block
        indicators, assembled with one batched matvec over the basis, and
        the coarse apply Q(res) = Z E⁺ Zᵀ res (blocks align with the
        slabs, so restriction is a local block sum and one all-gather)."""
        hk = self.acc_x.shape[0]
        nbh_loc = nbh // self.r
        ch, cw = hk // nbh_loc, self.w // nbw
        nc = nbh * nbw
        fluid, idx, mesh = self.fluid, self.idx, self.mesh

        def restrict(x):
            xb = (x * fluid).reshape(x.shape[0], nbh_loc, ch, nbw,
                                     cw).sum(dim=(2, 4))
            return _gather(xb, 1, mesh.space_group, self.r)

        def prolong(c):
            mine = c[:, idx * nbh_loc:(idx + 1) * nbh_loc]
            full = mine[:, :, None, :, None].expand(
                c.shape[0], nbh_loc, ch, nbw, cw).reshape(
                    c.shape[0], nbh_loc * ch, nbw * cw)
            return full * fluid

        z = prolong(torch.eye(nc, device=fluid.device).reshape(nc, nbh, nbw))
        e = restrict(self.matvec_raw(z)).reshape(nc, nc)
        e = 0.5 * (e + e.T)
        e_pinv = torch.linalg.pinv(e, rtol=1e-6)

        def q_apply(res):
            c = restrict(res).reshape(res.shape[0], nc)
            c = torch.einsum("ij,bj->bi", e_pinv, c)
            return prolong(c.reshape(res.shape[0], nbh, nbw))

        return q_apply


def _coarse_block_counts(h: int, w: int, r: int) -> tuple[int, int]:
    """The 'pcg2' coarse partition: ~16 blocks per axis, the H-axis count
    a multiple of r (blocks align with the slabs), both dividing the
    grid."""
    k = max(1, 16 // r)
    while k > 1 and h % (r * k):
        k //= 2
    nbh = r * k
    nbw = next((nb for nb in (16, 8, 4, 2, 1) if w % nb == 0), 1)
    return nbh, nbw


# ---------------------------------------------------------------------------
# The split fluid step.
# ---------------------------------------------------------------------------


def _edge(x, row: int, rows: int):
    """One local row (a plane of a volume) repeated `rows` times (the
    global clamp boundary)."""
    return x[:, row:row + 1].expand(x.shape[0], rows, *x.shape[2:])


def _face_above(nxt, x_top, rows: int, top):
    """Rows above a lower-face slab: the next rank's leading rows `nxt`;
    at the top rank, the real global top face `x_top` repeated."""
    return torch.where(top, x_top.expand(x_top.shape[0], rows,
                                         *x_top.shape[2:]), nxt)


def _abs(x):
    return torch.where(x >= 0, x, -x)


def _sample_shift_local(field, disp_y, disp_x, k, below, above):
    """`shift_bilinear_sample_2d` on a slab extended by halo rows, written
    as the JAX package's plain jnp code so that its autograd is JAX's at
    the ties: the clip is minimum(maximum(·)) (half the gradient to each
    side where it ties, as `jnp.clip`'s), the hat maximum(0, 1 − |d − o|)
    (half where it ties), and |x| is where(x ≥ 0, x, −x), whose gradient
    at 0 is +1 as JAX's abs has it (torch.abs's is 0).

    field: (B, Hk, W); below: (B, k, W) rows under the slab; above:
    (B, k+1, W) rows over it (the window's offsets −k..k+1)."""
    hk, w = field.shape[1], field.shape[2]
    lo, hi = field.new_tensor(-float(k)), field.new_tensor(float(k))
    zero = field.new_tensor(0.0)
    disp_y = torch.minimum(torch.maximum(disp_y, lo), hi)
    disp_x = torch.minimum(torch.maximum(disp_x, lo), hi)
    ext = torch.cat([below, field, above], dim=1)
    b, rows = ext.shape[:2]
    ext = torch.cat([ext[:, :, :1].expand(b, rows, k), ext,
                     ext[:, :, -1:].expand(b, rows, k + 1)], dim=2)
    out = torch.zeros_like(field)
    for oy in range(-k, k + 2):
        wy = torch.maximum(zero, 1.0 - _abs(disp_y - oy))
        row = ext[:, k + oy:k + oy + hk, :]
        for ox in range(-k, k + 2):
            wx = torch.maximum(zero, 1.0 - _abs(disp_x - ox))
            val = row[:, :, k + ox:k + ox + w]
            out = out + val * (wy * wx)
    return out


def _halos_cell(x, k_lo, k_hi, mesh, first, top):
    """Halo rows of a cell-indexed field, clamped at the global edges."""
    below, above = _exchange(x, k_lo, k_hi, mesh)
    below = torch.where(first, _edge(x, 0, k_lo), below)
    above = torch.where(top, _edge(x, x.shape[1] - 1, k_hi), above)
    return below, above


def _check_mode(domain, cfg, fn: str = "spatial_fluid_step",
                modes=("spectral", "pcg", "pcg2", "jax")) -> str:
    """The split step's scope (the JAX package's errors): closed, inviscid,
    shift-advected, and one of `modes` ('auto' resolved)."""
    if not domain.closed:
        raise ValueError(f"{fn} supports closed domains only (the dropped "
                         "global top face is identically zero only under "
                         "wall boundaries)")
    if cfg.viscosity:
        raise ValueError(f"{fn}: viscosity not implemented")
    if cfg.advection_mode != "shift":
        raise ValueError(f"{fn} requires shift advection")
    mode = cfg.pressure_backend
    if mode == "auto":
        mode = "pcg" if domain.has_obstacles else "spectral"
    if mode in ("pallas", "cuda"):
        raise ValueError(f"{fn}: the fused pressure kernel is single-device;"
                         " use " + "/".join(f"'{m}'" for m in
                                           ("auto",) + tuple(modes)))
    if mode == "spectral" and domain.has_obstacles:
        raise ValueError("'spectral' is exact only for domains without "
                         "obstacles; use " + "/".join(
                             f"'{m}'" for m in modes if m.startswith("pcg"))
                         + " (preconditioned CG)")
    if mode not in modes:
        raise ValueError(f"unknown pressure backend {cfg.pressure_backend!r}")
    return mode


def _spectral_tables(mode: str, h: int, w: int, dx: float, device):
    if mode == "jax":
        return None, None, None
    return (_on_device(_dct_matrix, (h,), device),
            _on_device(_dct_matrix, (w,), device),
            _on_device(_inv_neumann_eigenvalues, (h, w, float(dx)), device))


def spatial_fluid_step(
    state: FluidState,
    domain: Domain2D,
    cfg: FluidConfig,
    mesh: Mesh2D,
    force: Staggered2D | None = None,
    buoyancy_factor: torch.Tensor | None = None,
) -> FluidState:
    """One `fluid_step` on this rank's blocks (`spatial_shard` of the
    global state and force; `buoyancy_factor`: this rank's (B/D, 1, 1)
    rows), for the closed, inviscid, shift-advected scope. `domain` is the
    global domain. Pressure backends as the JAX package's: 'auto' →
    'spectral' without obstacles and 'pcg' with them; 'pcg2', 'jax'.
    Returns this rank's blocks of the next state (vy's replicated top
    face is zero)."""
    mode = _check_mode(domain, cfg)
    r = mesh.shape[SPACE_AXIS]
    h, w = domain.grid_shape
    k = int(cfg.max_shift)
    if h % r:
        raise ValueError(f"H={h} not divisible by space axis size {r}")
    if mode != "jax" and w % r:
        raise ValueError(f"W={w} not divisible by space axis size {r} "
                         "(the distributed spectral transform reduce-"
                         "scatters along W); use pressure_backend='jax'")
    if h // r < k + 2:
        raise ValueError(f"slab of {h // r} rows < max_shift+2={k + 2}; "
                         "use fewer space shards or a taller grid")
    dt, dx = cfg.dt, domain.dx
    dev = state.density.device
    rows = mesh.row_slice(h)
    h1 = rows.stop
    fluid, acc_x = domain.fluid_mask[rows], domain.acc_x[rows]
    acc_y_lo = domain.acc_y[rows]
    acc_above = domain.acc_y[h1:h1 + 1]  # the next slab's first face
    first, top = _flag(mesh.space_index == 0, dev), _flag(
        mesh.space_index == r - 1, dev)
    qh, qw, inv_lam = _spectral_tables(mode, h, w, dx, dev)
    nbh, nbw = (_coarse_block_counts(h, w, r) if mode == "pcg2"
                else (None, None))

    vy_lo, vy_top = state.velocity.vy[:, :-1, :], state.velocity.vy[:, -1:, :]
    vx, density = state.velocity.vx, state.density
    inflow = state.inflow
    if inflow is not None and inflow.dim() == 2:
        inflow = inflow.expand(density.shape)

    # --- advection (density first, then velocity, as advect.py) -----------
    vy_above1 = _face_above(_exchange(vy_lo, 0, 1, mesh)[1], vy_top, 1, top)
    vy_c = 0.5 * (vy_lo + torch.cat([vy_lo[:, 1:, :], vy_above1], dim=1))
    vx_c = 0.5 * (vx[:, :, :-1] + vx[:, :, 1:])

    d_below, d_above = _halos_cell(density, k, k + 1, mesh, first, top)
    density_new = _sample_shift_local(
        density, -dt * vy_c / dx, -dt * vx_c / dx, k, d_below, d_above)
    if inflow is not None:
        density_new = density_new + dt * inflow

    # vy at y-faces: native vy; vx resampled to the faces (previous row).
    vxc_prev = _exchange(vx_c, 1, 0, mesh)[0]
    vxc_prev = torch.where(first, vx_c[:, :1, :], vxc_prev)
    vx_at_y = 0.5 * (torch.cat([vxc_prev, vx_c[:, :-1, :]], dim=1) + vx_c)
    vy_below, vy_next = _exchange(vy_lo, k, k + 1, mesh)
    vy_below = torch.where(first, _edge(vy_lo, 0, k), vy_below)
    vy_above = _face_above(vy_next, vy_top, k + 1, top)
    vy_new = _sample_shift_local(
        vy_lo, -dt * vy_lo / dx, -dt * vx_at_y / dx, k, vy_below, vy_above)

    # vx at x-faces: native vx; vy resampled to the x-faces (local W pad).
    vyc_pad = torch.cat([vy_c[:, :, :1], vy_c, vy_c[:, :, -1:]], dim=2)
    vy_at_x = 0.5 * (vyc_pad[:, :, :-1] + vyc_pad[:, :, 1:])
    vx_below, vx_above = _halos_cell(vx, k, k + 1, mesh, first, top)
    vx_new = _sample_shift_local(
        vx, -dt * vy_at_x / dx, -dt * vx / dx, k, vx_below, vx_above)

    # --- forces and buoyancy (on the advected density) --------------------
    if force is not None:
        vy_new = vy_new + dt * force.vy[:, :-1, :]
        vx_new = vx_new + dt * force.vx
    b = cfg.buoyancy if buoyancy_factor is None else buoyancy_factor
    if buoyancy_factor is not None or cfg.buoyancy:
        dn_prev = _exchange(density_new, 1, 0, mesh)[0]
        dn_prev = torch.where(first, density_new[:, :1, :], dn_prev)
        d_at_y = 0.5 * (torch.cat([dn_prev, density_new[:, :-1, :]], dim=1)
                        + density_new)
        vy_new = vy_new + dt * b * d_at_y

    # --- projection: mask, divergence, CG solve, correct ------------------
    vy_m = vy_new * acc_y_lo
    vx_m = vx_new * acc_x
    vy_m_above = _face_above(_exchange(vy_m, 0, 1, mesh)[1],
                             torch.zeros_like(vy_top), 1, top)
    div = (torch.cat([vy_m[:, 1:, :], vy_m_above], dim=1) - vy_m
           + vx_m[:, :, 1:] - vx_m[:, :, :-1]) / dx

    ops = _PressureOps(mesh, fluid, acc_y_lo, acc_above, acc_x, w=w, dx=dx,
                       tol=cfg.pressure_tol, maxiter=cfg.pressure_maxiter,
                       mode=mode, qh=qh, qw=qw, inv_lam=inv_lam, nbh=nbh,
                       nbw=nbw)
    rhs = torch.where(fluid > 0, -div, 0.0)
    x0 = state.pressure
    guess = None if (x0 is None or mode == "spectral") else x0.detach()
    p = _LinearSolve.apply(rhs, ops.make_solve(guess), ops.make_solve(None))

    gy_lo, _, gx = ops.grad_p(p)
    vy2 = torch.cat([vy_m - gy_lo, torch.zeros_like(vy_top)], dim=1)
    return FluidState(
        velocity=Staggered2D(vy=vy2, vx=vx_m - gx), density=density_new,
        inflow=state.inflow,
        pressure=p if state.pressure is not None else None)


def spatial_pressure_solve_diag(
    div: torch.Tensor,
    domain: Domain2D,
    mesh: Mesh2D,
    mode: str = "pcg",
    tol: float = 1e-5,
    maxiter: int = 500,
):
    """The distributed pressure solve of the step outside its autograd
    Function, so that the trip count comes out: returns (this rank's
    pressure block, trips). div: this rank's (B/D, H/R, W) block. mode:
    'jax' | 'pcg' | 'pcg2' | 'spectral' (exact, obstacle-free; 0 trips)."""
    if mode == "spectral" and domain.has_obstacles:
        raise ValueError("'spectral' is exact only without obstacles")
    r = mesh.shape[SPACE_AXIS]
    h, w = domain.grid_shape
    if h % r or (mode != "jax" and w % r):
        raise ValueError(f"grid {h}x{w} not divisible by space={r}")
    rows = mesh.row_slice(h)
    qh, qw, inv_lam = _spectral_tables(mode, h, w, domain.dx, div.device)
    nbh, nbw = (_coarse_block_counts(h, w, r) if mode == "pcg2"
                else (None, None))
    fluid = domain.fluid_mask[rows]
    with torch.no_grad():
        ops = _PressureOps(mesh, fluid, domain.acc_y[rows],
                           domain.acc_y[rows.stop:rows.stop + 1],
                           domain.acc_x[rows], w=w, dx=domain.dx, tol=tol,
                           maxiter=maxiter, mode=mode, qh=qh, qw=qw,
                           inv_lam=inv_lam, nbh=nbh, nbw=nbw)
        rhs = ops.project(torch.where(fluid > 0, -div, 0.0))
        if mode == "spectral":
            return ops.project(ops.dist_spectral(rhs)), 0
        return ops.cg_solve(rhs, None)
