"""Consumers of the spatial domain decomposition: multi-step split
rollouts with backprop, and the adjoint force optimization through them.

Counterpart of `pde_control_tpu/parallel/spatial_opt.py`: the adjoint of
`control/adjoint.py :: optimize_forces` for grids whose rollout and
backprop would not fit one device. Every field and every optimization
variable stays split over the ('data', 'space') mesh end to end: the
states as `spatial_fluid_step` holds them, the forces and Adam's moments
as this rank's blocks (`force_shardings`), the loss as a sum of the
ranks' parts. The JAX package runs the loop as one jitted `lax.scan`;
here it is a Python loop of eager steps, and `remat` is accepted and
ignored (ROADMAP "Not ported, by design").
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pde_control_tpu_torch.control._adam import ClippedAdam
from pde_control_tpu_torch.grids import Domain2D, Staggered2D
from pde_control_tpu_torch.parallel.spatial import (
    DATA_AXIS,
    SPACE_AXIS,
    Mesh2D,
    spatial_fluid_step,
)
from pde_control_tpu_torch.physics.fluid import FluidConfig, FluidState


def force_shardings(mesh: Mesh2D) -> Staggered2D:
    """The layout of a rank's blocks of a time-stacked force (n, B,
    faces…): the mesh axis each array axis is split over. Both components
    split the batch over 'data' and H over 'space' (`spatial_shard`'s
    split; vy's block keeps the global top face as its last row); time
    and W are whole. The JAX package splits vy along W instead, because
    its NamedShardings cannot split the H+1 face rows."""
    spec = (None, DATA_AXIS, SPACE_AXIS, None)
    return Staggered2D(vy=spec, vx=spec)


def spatial_rollout(
    state0: FluidState,
    domain: Domain2D,
    cfg: FluidConfig,
    mesh: Mesh2D,
    forces: Staggered2D | None = None,
    n: int | None = None,
    remat: bool = True,
) -> FluidState:
    """`n` split fluid steps from this rank's blocks of `state0`,
    differentiable. forces: this rank's blocks of a force per step, with
    a leading time axis; without it, `n` free steps. `remat` is ignored."""
    if forces is None and n is None:
        raise ValueError("pass forces (time-stacked) or n")
    steps = forces.vy.shape[0] if forces is not None else n
    state = state0
    for t in range(steps):
        force = (None if forces is None
                 else Staggered2D(vy=forces.vy[t], vx=forces.vx[t]))
        state = spatial_fluid_step(state, domain, cfg, mesh, force=force)
    return state


def optimize_forces_spatial(
    state0: FluidState,
    target_density: torch.Tensor,
    domain: Domain2D,
    cfg: FluidConfig,
    mesh: Mesh2D,
    n: int,
    iterations: int = 100,
    learning_rate: float = 0.05,
    force_reg: float = 1e-3,
    grad_clip: float | None = 1.0,
    remat: bool = True,
    lr_schedule: str | None = None,  # None | 'cosine' (decay over the run)
):
    """Adjoint force optimization through the split solver: Adam on a
    per-step force sequence through the unrolled rollout, loss =
    MSE(final density, target) + force_reg · dx²·mean_B Σ f², as the JAX
    package's. state0 and target_density are this rank's blocks. The
    clip's global norm is all-reduced over the mesh; 'cosine' decays the
    rate to 0 over the run (optax's `cosine_decay_schedule`).

    Returns (forces, history): this rank's force blocks and the global
    loss terms of each iteration ('total', 'obs_loss', 'force_cost', as
    tensors of `iterations`)."""
    if lr_schedule not in (None, "cosine"):
        raise ValueError(f"unknown lr_schedule {lr_schedule!r}")
    b, hk, w = state0.density.shape
    b_all = b * mesh.shape[DATA_AXIS]
    h = hk * mesh.shape[SPACE_AXIS]
    dev = state0.density.device
    # The top face's force never enters the step, so it keeps its zero
    # start (its gradient is 0): only the lower faces are variables.
    shapes = [(n, b, hk, w), (n, b, hk, w + 1)]
    sizes = [s[0] * s[1] * s[2] * s[3] for s in shapes]
    flat = torch.zeros(sum(sizes), device=dev, requires_grad=True)
    optimizer = ClippedAdam(
        flat.numel(), dev, learning_rate, grad_clip,
        max(iterations, 1) if lr_schedule == "cosine" else None, alpha=0.0)
    dx2 = domain.dx * domain.dx
    zero_top = torch.zeros((n, b, 1, w), device=dev)

    def forces():
        fy, fx = (v.view(s) for v, s in zip(flat.split(sizes), shapes))
        return Staggered2D(vy=torch.cat([fy, zero_top], dim=2), vx=fx)

    history = torch.zeros((3, iterations), device=dev)
    for i in range(iterations):
        flat.grad = None
        f = forces()
        final = spatial_rollout(state0, domain, cfg, mesh, forces=f)
        obs = torch.sum((final.density - target_density) ** 2) / (
            b_all * h * w)
        effort = dx2 * (torch.sum(f.vy ** 2) + torch.sum(f.vx ** 2)) / b_all
        (obs + force_reg * effort).backward()
        with torch.no_grad():
            terms = torch.stack([obs, effort]).detach()
            g = flat.grad
            sq = (g * g).sum().reshape(1)
            both = torch.cat([terms, sq])
            dist.all_reduce(both)
            history[:, i] = torch.stack([both[0] + force_reg * both[1],
                                         both[0], both[1]])
            flat.add_(optimizer.update(g, norm=torch.sqrt(both[2])))
    f = forces()
    return Staggered2D(vy=f.vy.detach(), vx=f.vx.detach()), {
        "total": history[0], "obs_loss": history[1],
        "force_cost": history[2]}
