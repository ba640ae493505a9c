"""Multi-rank runs for the port's parallel tests, on the CPU.

`run_ranks` spawns a world of processes (`torch.multiprocessing`), each
with one torch thread and a gloo group initialised through a `FileStore`
under the test's tmp_path (no TCP port, so parallel test workers do not
collide), runs a worker of this module in each and returns what each
returned. Imports no JAX: the references are taken in the pytest process.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, store, out, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start_ranks(fn, world: int, tmp, *args):
    """Spawn `world` ranks running fn(rank, *args) without waiting; pass
    the returned handle to `join_ranks`."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.spawn(_entry, args=(fn, world, os.path.join(tmp, "store"), tmp,
                                 args), nprocs=world, join=False)
    return ctx, tmp, world


def join_ranks(handle) -> list:
    """Each rank's return value, after all of them have ended (a rank's
    exception is raised here)."""
    ctx, tmp, world = handle
    while not ctx.join():
        pass
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def run_ranks(fn, world: int, tmp, *args) -> list:
    return join_ranks(start_ranks(fn, world, tmp, *args))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


# ------------------------------------------------------------------ DP


def _burgers_app(mesh, params, **kw):
    from pde_control_tpu_torch import ControlTraining
    from pde_control_tpu_torch.control.pde_burgers import BurgersPDE
    from pde_control_tpu_torch.physics.burgers import BurgersConfig

    app = ControlTraining(
        2, BurgersPDE(BurgersConfig(n=16, dt=0.5, viscosity=0.05),
                      device="cpu"), batch_size=8,
        trainable_networks=("CFE",), sequence_class="chain",
        obs_loss_frames=(1, 2), seed=3, mesh=mesh, **kw).prepare()
    app.load_params(params)
    return app


def _params(app) -> dict:
    return {name: {k: _np(v) for k, v in sd.items()}
            for name, sd in app.state_dicts().items()}


def dp_burgers(rank, params, batch, nan_batch, obs, workdir):
    """The Burgers DP case of tests/test_torch_mesh.py on a world of 2:
    one `progress` (loss, parameters), `evaluate`, a NaN in rank 1's
    shard, `make_mesh`'s world-size check, the broadcast of a rank's
    different parameters, and rank-0-only writes of a short `train`."""
    from pde_control_tpu_torch.data.scene import TrajectoryDataset
    from pde_control_tpu_torch.parallel.mesh import make_mesh

    try:
        make_mesh(3, device="cpu")
        wrong_world = None
    except ValueError as e:
        wrong_world = str(e)
    mesh = make_mesh(2, device="cpu")
    out = {"wrong_world": wrong_world, "size": mesh.size}
    if rank == 1:  # a different start: prepare()/load_params broadcast
        params = {net: {k: v + 1.0 for k, v in sd.items()}
                  for net, sd in params.items()}
    app = _burgers_app(mesh, params)
    out["start"] = _params(app)
    m = app.progress(batch)
    out["loss"] = float(m["loss"])
    out["params"] = _params(app)
    out["eval"] = app.evaluate(batch)
    before = _params(app)
    m = app.progress(nan_batch)
    out["nan"] = dict(loss=float(m["loss"]),
                      total=int(app.notfinite_total),
                      consec=int(app.notfinite_consec),
                      count=int(app.optimizer.count),
                      kept=all(np.array_equal(before[n][k], v)
                               for n, sd in _params(app).items()
                               for k, v in sd.items()))
    app = _burgers_app(mesh, params, dataset=TrajectoryDataset(obs),
                       logdir=os.path.join(workdir, f"logs_r{rank}"))
    app.train(4, log_every=2, steps_per_call=2, render=False,
              autosave_dir=os.path.join(workdir, "autosave"),
              autosave_every=2)
    app.save(os.path.join(workdir, "ckpt"))
    out["trained"] = _params(app)
    return out


def _fluid_app(mesh, params, pde_kw, cfg_kw, h):
    from pde_control_tpu_torch import (
        ControlTraining,
        Domain2D,
        FluidConfig,
        IncompressibleFluidPDE,
    )

    pde = IncompressibleFluidPDE(Domain2D.create(h, h, device="cpu"),
                                 FluidConfig(**cfg_kw), dtype=torch.float32,
                                 **pde_kw)
    app = ControlTraining(2, pde, batch_size=4, mesh=mesh,
                          trainable_networks=("CFE", "OP2"),
                          sequence_class="staggered").prepare()
    app.load_params(params)
    return app


def dp_fluid(rank, params, pde_kw, cfg_kw, h, batch, batches):
    """The 2D fluid DP case: one `progress`, then `progress_multi` of two
    steps; loss and parameters after each."""
    from pde_control_tpu_torch.parallel.mesh import make_mesh

    app = _fluid_app(make_mesh(2, device="cpu"), params, pde_kw, cfg_kw, h)
    out = {"loss": float(app.progress(batch)["loss"]), "params": _params(app)}
    m = app.progress_multi(batches)
    out["multi_loss"] = _np(m["loss"])
    out["multi_params"] = _params(app)
    return out


# ------------------------------------------------------------- spatial


def spatial_cases(rank, n_data, n_space, inputs, cases, steps):
    """The split rollout's loss, final state and force gradient (global,
    gathered) for each case {name: (mode, plate, max_shift)} of
    tests/test_torch_spatial.py, and the layout checks; rank 0 returns
    them."""
    from pde_control_tpu_torch import Domain2D, FluidConfig, FluidState
    from pde_control_tpu_torch.grids import Staggered2D
    from pde_control_tpu_torch.parallel.spatial import (
        make_mesh2d,
        spatial_fluid_step,
        spatial_gather,
        spatial_shard,
    )

    mesh = make_mesh2d(n_data, n_space, device="cpu")
    t = {k: torch.tensor(v) for k, v in inputs.items()}
    b, h, w = t["density"].shape
    out = {"_checks": _layout_checks(mesh, b, h, w)}
    for name, (mode, plate, k) in cases.items():
        domain = Domain2D.create(h, w, obstacle_mask=t["plate"] if plate
                                 else None, device="cpu")
        cfg = FluidConfig(dt=0.5, buoyancy=0.1, pressure_tol=1e-7,
                          pressure_maxiter=800, pressure_backend=mode,
                          max_shift=k)
        state = spatial_shard(FluidState(
            velocity=Staggered2D.zeros(b, h, w, device="cpu"),
            density=t["density"]), mesh)
        force = spatial_shard(Staggered2D(vy=t["fy"], vx=t["fx"]), mesh)
        force = Staggered2D(vy=force.vy.clone().requires_grad_(),
                            vx=force.vx.clone().requires_grad_())
        target = spatial_shard(t["target"], mesh)
        for _ in range(steps):
            state = spatial_fluid_step(state, domain, cfg, mesh, force=force)
        loss = torch.sum((state.density - target) ** 2) / (b * h * w)
        loss.backward()
        total = loss.detach().reshape(1)
        dist.all_reduce(total)
        g = spatial_gather(Staggered2D(vy=force.vy.grad, vx=force.vx.grad),
                           mesh, grad=True)
        final = spatial_gather(Staggered2D(vy=state.velocity.vy.detach(),
                                           vx=state.velocity.vx.detach()),
                               mesh)
        out[name] = dict(loss=float(total),
                         density=_np(spatial_gather(state.density.detach(),
                                                    mesh)),
                         vy=_np(final.vy), vx=_np(final.vx),
                         gvy=_np(g.vy), gvx=_np(g.vx))
    return out if rank == 0 else None


def _layout_checks(mesh, b, h, w) -> dict:
    """`spatial_shard` then `spatial_gather` of a state (inflow and
    pressure too) and of a time-stacked force give them back; the
    reduce-scatter sums the space group's blocks and its backward
    all-gathers the gradient."""
    from pde_control_tpu_torch import FluidState
    from pde_control_tpu_torch.grids import Staggered2D
    from pde_control_tpu_torch.parallel.spatial import (
        _ReduceScatter,
        spatial_gather,
        spatial_shard,
    )

    g = torch.Generator().manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    state = FluidState(velocity=Staggered2D(vy=rnd(b, h + 1, w),
                                            vx=rnd(b, h, w + 1)),
                       density=rnd(b, h, w), inflow=rnd(h, w),
                       pressure=rnd(b, h, w))
    back = spatial_gather(spatial_shard(state, mesh), mesh)
    forces = Staggered2D(vy=rnd(3, b, h + 1, w), vx=rnd(3, b, h, w + 1))
    fback = spatial_gather(spatial_shard(forces, mesh), mesh)
    same = all(torch.equal(x, y) for x, y in (
        (back.velocity.vy, state.velocity.vy),
        (back.velocity.vx, state.velocity.vx),
        (back.density, state.density), (back.inflow, state.inflow),
        (back.pressure, state.pressure), (fback.vy, forces.vy),
        (fback.vx, forces.vx)))
    ns, s = mesh.shape["space"], mesh.space_index
    base = rnd(b, h, w)
    x = (base * (s + 1)).requires_grad_()
    y = _ReduceScatter.apply(x, 1, mesh)
    rows = mesh.row_slice(h)
    want = base[:, rows] * sum(range(1, ns + 1))
    cots = [torch.randn((b, h // ns, w),
                        generator=torch.Generator().manual_seed(100 + r))
            for r in range(ns)]
    (y * cots[s]).sum().backward()
    return {"round_trip": same,
            "reduce_scatter": bool(torch.allclose(y, want, atol=1e-5)),
            "reduce_scatter_grad": torch.equal(x.grad, torch.cat(cots, 1))}


# -------------------------------------------------------- spatial_opt


def spatial_opt(rank, inputs, opt_kw, indirect, diag):
    """tests/test_torch_spatial_opt.py's cases on a world of 2 or 4 ranks,
    a (1, 2) or (2, 2) mesh: the adjoint `optimize_forces_spatial` (its
    history, its forces gathered); on (2, 2), the warm-started indirect
    inflow case (loss, the buoyancy factor's gradient);
    `spatial_pressure_solve_diag` 'pcg' and 'pcg2' (pressure, trips)."""
    from pde_control_tpu_torch import Domain2D, FluidConfig, FluidState
    from pde_control_tpu_torch.grids import Staggered2D
    from pde_control_tpu_torch.parallel.spatial import (
        _gather,
        make_mesh2d,
        spatial_fluid_step,
        spatial_gather,
        spatial_pressure_solve_diag,
        spatial_shard,
    )
    from pde_control_tpu_torch.parallel.spatial_opt import (
        optimize_forces_spatial,
    )

    world = dist.get_world_size()
    mesh = make_mesh2d(world // 2, 2, device="cpu")
    t = {k: torch.tensor(v) for k, v in inputs.items()}
    b, h, w = t["density"].shape
    domain = Domain2D.create(h, w, device="cpu")
    cfg = FluidConfig(dt=0.5, buoyancy=0.0, pressure_tol=1e-5,
                      pressure_maxiter=200, pressure_backend="spectral")
    state0 = spatial_shard(FluidState(
        velocity=Staggered2D.zeros(b, h, w, device="cpu"),
        density=t["density"]), mesh)
    forces, hist = optimize_forces_spatial(
        state0, spatial_shard(t["target"], mesh), domain, cfg, mesh,
        **opt_kw)
    f = spatial_gather(forces, mesh)
    out = {"opt": dict({k: _np(v) for k, v in hist.items()},
                       fvy=_np(f.vy), fvx=_np(f.vx))}
    if world == 4:
        t = {k: torch.tensor(v) for k, v in indirect.items()}
        b, h, w = t["density"].shape
        domain = Domain2D.create(h, w, obstacle_mask=t["plate"],
                                 device="cpu")
        cfg = FluidConfig(dt=0.5, buoyancy=0.1, pressure_tol=1e-7,
                          pressure_maxiter=800, pressure_backend="pcg")
        state = spatial_shard(FluidState(
            velocity=Staggered2D.zeros(b, h, w, device="cpu"),
            density=t["density"], inflow=t["inflow"],
            pressure=torch.zeros(b, h, w)), mesh)
        bf = t["bf"][mesh.batch_slice(b)].clone().requires_grad_()
        for _ in range(2):
            state = spatial_fluid_step(state, domain, cfg, mesh,
                                       buoyancy_factor=bf)
        target = spatial_shard(t["target"], mesh)
        loss = torch.sum((state.density - target) ** 2) / (b * h * w)
        loss.backward()
        total = loss.detach().reshape(1)
        dist.all_reduce(total)
        g = bf.grad.clone()
        dist.all_reduce(g, group=mesh.space_group)
        out["indirect"] = dict(loss=float(total), gbf=_np(_gather(
            g, 0, mesh.data_group, mesh.shape["data"])))
    dmesh = mesh
    t = {k: torch.tensor(v) for k, v in diag.items()}
    h = t["plate"].shape[0]
    domain = Domain2D.create(h, h, obstacle_mask=t["plate"], device="cpu")
    div = spatial_shard(t["div"], dmesh)
    for mode in ("pcg", "pcg2"):
        p, trips = spatial_pressure_solve_diag(div, domain, dmesh, mode=mode,
                                               tol=1e-6, maxiter=2000)
        out[f"diag_{mode}"] = dict(p=_np(spatial_gather(p, dmesh)),
                                   trips=trips)
    return out if rank == 0 else None


# ----------------------------------------------------------- spatial3d


def spatial3d_cases(rank, n_data, n_space, inputs, cases, steps):
    """The split 3D rollout of tests/test_torch_spatial3d.py for each case
    {name: (mode, plate, factor)} (factor: 'full', 'batch' or None; with a
    factor the state also carries the inflow and a warm-started pressure):
    the loss (the final density's squared error summed per sample), the
    final state and the gradients of the force and the
    factor (global, gathered); then the layout checks and
    `spatial_pressure_solve3d_diag` ('pcg', 'jax') on the plate. Every
    rank returns its trips; rank 0 returns the rest."""
    from pde_control_tpu_torch import Domain3D, Fluid3DConfig, FluidState3D
    from pde_control_tpu_torch.grids3d import Staggered3D
    from pde_control_tpu_torch.parallel.spatial import (
        _gather,
        spatial_gather,
        spatial_shard,
    )
    from pde_control_tpu_torch.parallel.spatial3d import (
        make_mesh2d,
        spatial_fluid3d_step,
        spatial_pressure_solve3d_diag,
    )

    mesh = make_mesh2d(n_data, n_space, device="cpu")
    t = {k: torch.tensor(v) for k, v in inputs.items()}
    b, d, h, w = t["density"].shape

    def shard(x):
        return spatial_shard(x, mesh, ndim=3)

    def gather(x, grad=False):
        return spatial_gather(x, mesh, ndim=3, grad=grad)

    out = {"_checks": _layout_checks3d(mesh, b, d, h, w)}
    for name, (mode, plate, factor) in cases.items():
        domain = Domain3D.create(d, h, w, obstacle_mask=t["plate"] if plate
                                 else None, device="cpu")
        cfg = Fluid3DConfig(dt=0.5, buoyancy=0.1, pressure_tol=1e-7,
                            pressure_maxiter=800, pressure_backend=mode)
        extra = {} if factor is None else dict(
            inflow=t["inflow"], pressure=torch.zeros(b, d, h, w))
        state = shard(FluidState3D(
            velocity=Staggered3D.zeros(b, d, h, w, device="cpu"),
            density=t["density"], **extra))
        force = shard(Staggered3D(vz=t["fz"], vy=t["fy"], vx=t["fx"]))
        force = Staggered3D(*(f.clone().requires_grad_() for f in (
            force.vz, force.vy, force.vx)))
        bf = None
        if factor == "full":
            bf = shard(t["bf_full"]).requires_grad_()
        elif factor == "batch":
            bf = t["bf_batch"][mesh.batch_slice(b)].clone().requires_grad_()
        for _ in range(steps):
            state = spatial_fluid3d_step(state, domain, cfg, mesh,
                                         force=force, buoyancy_factor=bf)
        loss = torch.sum((state.density - shard(t["target"])) ** 2) / b
        loss.backward()
        total = loss.detach().reshape(1)
        dist.all_reduce(total)
        g = gather(Staggered3D(force.vz.grad, force.vy.grad, force.vx.grad),
                   grad=True)
        v = gather(Staggered3D(*(x.detach() for x in (
            state.velocity.vz, state.velocity.vy, state.velocity.vx))))
        res = dict(loss=float(total), density=_np(gather(
            state.density.detach())), vz=_np(v.vz), vy=_np(v.vy),
                   vx=_np(v.vx), gvz=_np(g.vz), gvy=_np(g.vy), gvx=_np(g.vx))
        if factor == "full":
            res["gbf"] = _np(gather(bf.grad))
        elif factor == "batch":
            gbf = bf.grad.clone()
            dist.all_reduce(gbf, group=mesh.space_group)  # replicated rows
            res["gbf"] = _np(_gather(gbf, 0, mesh.data_group,
                                     mesh.shape["data"]))
        out[name] = res
    domain = Domain3D.create(d, h, w, obstacle_mask=t["plate"], device="cpu")
    for mode in ("pcg", "jax"):
        p, trips = spatial_pressure_solve3d_diag(
            shard(t["div"]), domain, mesh, mode=mode, tol=1e-5, maxiter=2000)
        out[f"diag_{mode}"] = dict(p=_np(gather(p)), trips=trips)
    return out if rank == 0 else {f"diag_{m}": dict(trips=out[f"diag_{m}"][
        "trips"]) for m in ("pcg", "jax")}


def _layout_checks3d(mesh, b, d, h, w) -> dict:
    """`spatial_shard` then `spatial_gather` (ndim=3) of a `FluidState3D`
    (inflow and pressure too) and of a time-stacked `Staggered3D` give
    them back; with `grad`, the replicated top z-face of a vz block is
    summed over the space group once."""
    from pde_control_tpu_torch import FluidState3D
    from pde_control_tpu_torch.grids3d import Staggered3D
    from pde_control_tpu_torch.parallel.spatial import (
        spatial_gather,
        spatial_shard,
    )

    g = torch.Generator().manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    def vel(*lead):
        return Staggered3D(vz=rnd(*lead, b, d + 1, h, w),
                           vy=rnd(*lead, b, d, h + 1, w),
                           vx=rnd(*lead, b, d, h, w + 1))

    state = FluidState3D(velocity=vel(), density=rnd(b, d, h, w),
                         inflow=rnd(d, h, w), pressure=rnd(b, d, h, w))
    back = spatial_gather(spatial_shard(state, mesh, 3), mesh, 3)
    forces = vel(3)
    fback = spatial_gather(spatial_shard(forces, mesh, 3), mesh, 3)
    pairs = [(back.velocity.vz, state.velocity.vz),
             (back.velocity.vy, state.velocity.vy),
             (back.velocity.vx, state.velocity.vx),
             (back.density, state.density), (back.inflow, state.inflow),
             (back.pressure, state.pressure), (fback.vz, forces.vz),
             (fback.vy, forces.vy), (fback.vx, forces.vx)]
    sharded = spatial_shard(state.velocity, mesh, 3)
    ns = mesh.shape["space"]
    bd, zk = b // mesh.shape["data"], d // ns
    shapes = (tuple(sharded.vz.shape) == (bd, zk + 1, h, w)
              and tuple(sharded.vy.shape) == (bd, zk, h + 1, w)
              and tuple(sharded.vx.shape) == (bd, zk, h, w + 1))
    # Each rank's gradient block holds 1 on its replicated top plane: the
    # gathered top face must count every rank of the space group once.
    ones = Staggered3D(*(torch.ones_like(x) for x in (
        sharded.vz, sharded.vy, sharded.vx)))
    gsum = spatial_gather(ones, mesh, 3, grad=True)
    grad_sum = (bool((gsum.vz[:, -1] == ns).all())
                and bool((gsum.vz[:, :-1] == 1).all())
                and bool((gsum.vy == 1).all()) and bool((gsum.vx == 1).all()))
    return {"round_trip": all(torch.equal(x, y) for x, y in pairs),
            "block_shapes": shapes, "grad_sum": grad_sum}
