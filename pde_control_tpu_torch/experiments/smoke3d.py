"""3D smoke control: buoyant blobs in a closed volume pushed by withheld
random forcing (`smoke3d`), and an inflow-driven plume steered through an
obstacle plate by a buoyancy-only controller (`smoke3d_indirect`), each
controlled by the dim=3 CFE/OP stack through the staged curriculum.

Counterpart of `pde_control_tpu/experiments/smoke3d.py`. The obstacle-free
box solves every pressure exactly (the 3D spectral solve); the plate
sends the solve to the spectrally preconditioned CG ('pcg'), which runs
all of its `maxiter` trips while a CUDA graph is being captured
(`physics/poisson.py :: cg`), so `progress_multi` captures each stage's
step as one CUDA graph on both tasks.

Randomness comes from a `torch.Generator` seeded by `seed`. `jax.random`'s
bits cannot be reproduced in torch, so each random function is split into
its draws (`*_draws`) and a deterministic construction from them
(`*_from_draws`): fed the same draws, the constructions match the JAX
package's. Draws are made on the CPU; the constructions and the rollouts
run on the domain's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pde_control_tpu_torch.control.pde_fluid3d import IncompressibleFluid3DPDE
from pde_control_tpu_torch.data.scene import TrajectoryDataset
from pde_control_tpu_torch.experiments.curriculum import (
    CurriculumConfig,
    finetune_e2e,
    run_curriculum,
)
from pde_control_tpu_torch.grids3d import (
    Domain3D,
    Staggered3D,
    centered_to_x_faces_3d,
    centered_to_y_faces_3d,
    centered_to_z_faces,
)
from pde_control_tpu_torch.physics.fluid3d import (
    Fluid3DConfig,
    FluidState3D,
    fluid3d_step,
)


def blob3d_draws(gen: torch.Generator, batch: int, d: int, h: int, w: int,
                 sigma_range=(2.0, 4.0), margin: int = 4):
    """Centres (B, 3) as (z, y, x), uniform in [m, n - m) per axis with the
    margin m clamped to a third of the smallest side (at least 1), and
    widths (B, 1, 1, 1)."""
    m = min(margin, max(1, min(d, h, w) // 3))
    hi = torch.tensor([d - m, h - m, w - m], dtype=torch.float32)
    pos = m + torch.rand((batch, 3), generator=gen) * (hi - m)
    lo_s, hi_s = sigma_range
    sig = lo_s + torch.rand((batch, 1, 1, 1), generator=gen) * (hi_s - lo_s)
    return pos, sig


def blobs3d_from_draws(pos: torch.Tensor, sig: torch.Tensor, d: int, h: int,
                       w: int) -> torch.Tensor:
    """Gaussian density blobs (B, D, H, W) of peak 1."""
    kw = dict(dtype=torch.float32, device=pos.device)
    zz = torch.arange(d, **kw)[None, :, None, None]
    yy = torch.arange(h, **kw)[None, None, :, None]
    xx = torch.arange(w, **kw)[None, None, None, :]
    r2 = ((zz - pos[:, 0, None, None, None]) ** 2
          + (yy - pos[:, 1, None, None, None]) ** 2
          + (xx - pos[:, 2, None, None, None]) ** 2)
    return torch.exp(-r2 / (2 * sig ** 2))


def random_blobs_3d(gen: torch.Generator, batch: int, d: int, h: int, w: int,
                    sigma_range=(2.0, 4.0), margin: int = 4) -> torch.Tensor:
    """Random Gaussian density blobs (B, D, H, W), peak 1."""
    return blobs3d_from_draws(*blob3d_draws(gen, batch, d, h, w, sigma_range,
                                            margin), d, h, w)


def smooth3d_draws(gen: torch.Generator, batch: int, modes: int = 2):
    """Unit normal amplitudes (B, M, M, M) and phases in [0, 2π) for z, y
    and x (B, M, 1 each)."""
    amps = torch.randn((batch, modes, modes, modes), generator=gen)
    phases = [torch.rand((batch, modes, 1), generator=gen) * (2 * math.pi)
              for _ in range(3)]
    return (amps, *phases)


def smooth3d_from_draws(amps: torch.Tensor, phz: torch.Tensor,
                        phy: torch.Tensor, phx: torch.Tensor, d: int, h: int,
                        w: int, amplitude: float = 1.0) -> torch.Tensor:
    """Smooth (B, D, H, W) field from low-frequency sine modes."""
    modes = amps.shape[1]
    kw = dict(dtype=torch.float32, device=amps.device)
    m = torch.arange(1, modes + 1, **kw)
    s = [torch.sin(m[None, :, None]
                   * (torch.arange(n, **kw) * (math.pi / n))[None, None, :]
                   + ph) for n, ph in ((d, phz), (h, phy), (w, phx))]
    return torch.einsum("bmz,bny,box,bmno->bzyx", *s,
                        amps * amplitude) / (modes ** 1.5)


def random_smooth_field_3d(gen: torch.Generator, batch: int, d: int, h: int,
                           w: int, modes: int = 2, amplitude: float = 1.0
                           ) -> torch.Tensor:
    """Random smooth (B, D, H, W) fields from low-frequency modes."""
    return smooth3d_from_draws(*smooth3d_draws(gen, batch, modes), d, h, w,
                               amplitude=amplitude)


def forced_smoke3d_rollout(domain: Domain3D, cfg: Fluid3DConfig,
                           density0: torch.Tensor, force: Staggered3D,
                           n_steps: int) -> torch.Tensor:
    """n_steps from rest under a force constant in time (no pressure warm
    start, as the JAX generator's state carries none). Returns the
    densities (n_steps + 1, B, D, H, W), frame 0 the initial one."""
    d, h, w = domain.grid_shape
    with torch.no_grad():
        state = FluidState3D(
            velocity=Staggered3D.zeros(density0.shape[0], d, h, w,
                                       device=density0.device),
            density=density0)
        frames = [density0]
        for _ in range(n_steps):
            state = fluid3d_step(state, domain, cfg, force=force)
            frames.append(state.density)
    return torch.stack(frames)


def generate_forced_smoke3d_dataset(
    domain: Domain3D,
    cfg: Fluid3DConfig,
    num: int,
    n_steps: int,
    seed: int = 0,
    force_amplitude: float = 0.15,
    batch: int = 4,
) -> TrajectoryDataset:
    """Blobs pushed by withheld random forces, constant in time (the
    controller must reconstruct their effect). Each chunk of `batch` draws
    its blobs, then the force's z, y and x fields, centred and moved to the
    faces. Returns obs (num, n_steps + 1, D, H, W, 1)."""
    d, h, w = domain.grid_shape
    dev = domain.device
    gen = torch.Generator().manual_seed(seed)
    chunks = []
    remaining = num
    while remaining > 0:
        b = min(batch, remaining)
        d0 = blobs3d_from_draws(*(t.to(dev) for t in
                                  blob3d_draws(gen, b, d, h, w)), d, h, w)
        fz, fy, fx = (smooth3d_from_draws(
            *(t.to(dev) for t in smooth3d_draws(gen, b)), d, h, w,
            amplitude=force_amplitude) for _ in range(3))
        force = Staggered3D(vz=centered_to_z_faces(fz),
                            vy=centered_to_y_faces_3d(fy),
                            vx=centered_to_x_faces_3d(fx))
        traj = forced_smoke3d_rollout(domain, cfg, d0, force, n_steps)
        chunks.append(np.moveaxis(traj.cpu().numpy(), 0, 1)[..., None])
        remaining -= b
    return TrajectoryDataset(np.concatenate(chunks, axis=0))


def obstacle_plate_3d(d: int, h: int, w: int) -> np.ndarray:
    """A horizontal plate two cells thick at mid-height with a square hole
    off the center (1 = solid): the rising plume must pass the hole."""
    mask = np.zeros((d, h, w), np.float32)
    z0 = int(d * 0.5)
    mask[z0:z0 + 2, :, :] = 1.0
    hy, hx = int(h * 0.30), int(w * 0.55)
    hole = max(3, h // 5)
    mask[z0:z0 + 2, hy:hy + hole, hx:hx + hole] = 0.0
    return mask


def inflow3d_draws(gen: torch.Generator, batch: int, h: int, w: int
                   ) -> torch.Tensor:
    """The sources' (y, x) positions (B, 2), uniform in [0.2, 0.8) of each
    side."""
    lo = torch.tensor([0.2 * h, 0.2 * w], dtype=torch.float32)
    hi = torch.tensor([0.8 * h, 0.8 * w], dtype=torch.float32)
    return lo + torch.rand((batch, 2), generator=gen) * (hi - lo)


def inflow3d_from_draws(pos: torch.Tensor, d: int, h: int, w: int,
                        rate: float = 0.08, sigma: float = 2.0,
                        z0: float = 3.0) -> torch.Tensor:
    """Continuous smoke sources (B, D, H, W): a Gaussian emitter of peak
    `rate` at height z0 near the bottom wall, at each (y, x) of `pos`."""
    kw = dict(dtype=torch.float32, device=pos.device)
    zz = torch.arange(d, **kw)[None, :, None, None]
    yy = torch.arange(h, **kw)[None, None, :, None]
    xx = torch.arange(w, **kw)[None, None, None, :]
    r2 = ((zz - z0) ** 2 + (yy - pos[:, 0, None, None, None]) ** 2
          + (xx - pos[:, 1, None, None, None]) ** 2)
    return rate * torch.exp(-r2 / (2 * sigma ** 2))


def random_inflow_3d(gen: torch.Generator, batch: int, d: int, h: int,
                     w: int, rate: float = 0.08, sigma: float = 2.0,
                     z0: float = 3.0) -> torch.Tensor:
    """Random continuous smoke sources (B, D, H, W) near the bottom wall."""
    return inflow3d_from_draws(inflow3d_draws(gen, batch, h, w), d, h, w,
                               rate, sigma, z0)


def inflow_smoke3d_rollout(domain: Domain3D, cfg: Fluid3DConfig,
                           inflow: torch.Tensor, b_field: torch.Tensor,
                           n_steps: int, warmup: int):
    """From rest with no smoke: `warmup` unforced steps, then n_steps with
    the buoyancy modulation vz += dt·b·ρ on z-faces (cold pressure solves,
    as the JAX generator's state carries no pressure). Returns the
    densities (n_steps + 1, B, D, H, W) from the end of the warm-up on, and
    the velocity there."""
    d, h, w = domain.grid_shape
    with torch.no_grad():
        state = FluidState3D(
            velocity=Staggered3D.zeros(inflow.shape[0], d, h, w,
                                       device=inflow.device),
            density=torch.zeros_like(inflow), inflow=inflow)
        for _ in range(warmup):
            state = fluid3d_step(state, domain, cfg)
        velocity0 = state.velocity
        frames = [state.density]
        for _ in range(n_steps):
            v = state.velocity
            force = Staggered3D(vz=centered_to_z_faces(b_field * state.density),
                                vy=torch.zeros_like(v.vy),
                                vx=torch.zeros_like(v.vx))
            state = fluid3d_step(state, domain, cfg, force=force)
            frames.append(state.density)
    return torch.stack(frames), velocity0


def generate_inflow_smoke3d_dataset(
    domain: Domain3D,
    cfg: Fluid3DConfig,
    num: int,
    n_steps: int,
    seed: int = 0,
    control_amplitude: float = 0.3,
    batch: int = 4,
    warmup: int = 6,
) -> TrajectoryDataset:
    """An inflow-driven plume through the domain's obstacles, steered by a
    withheld random buoyancy-modulation field b(x), applied as the
    buoyancy-mode CFE applies control. `warmup` unforced steps develop the
    plume before frame 0 (indirect forcing has no authority over an empty
    domain). Each chunk of `batch` draws its sources, then the field.
    Returns obs (num, n_steps + 1, D, H, W, 1) with the extras `inflow`
    (num, D, H, W) and the velocity at frame 0, `vz0`, `vy0`, `vx0`."""
    d, h, w = domain.grid_shape
    dev = domain.device
    gen = torch.Generator().manual_seed(seed)
    chunks, inflows, v0 = [], [], {"vz0": [], "vy0": [], "vx0": []}
    remaining = num
    while remaining > 0:
        b = min(batch, remaining)
        inflow = inflow3d_from_draws(inflow3d_draws(gen, b, h, w).to(dev),
                                     d, h, w)
        b_field = smooth3d_from_draws(
            *(t.to(dev) for t in smooth3d_draws(gen, b)), d, h, w,
            amplitude=control_amplitude)
        traj, vel0 = inflow_smoke3d_rollout(domain, cfg, inflow, b_field,
                                            n_steps, warmup)
        chunks.append(np.moveaxis(traj.cpu().numpy(), 0, 1)[..., None])
        inflows.append(inflow.cpu().numpy())
        for k in v0:
            v0[k].append(getattr(vel0, k[:2]).cpu().numpy())
        remaining -= b
    return TrajectoryDataset(
        np.concatenate(chunks, axis=0),
        inflow=np.concatenate(inflows, axis=0),
        **{k: np.concatenate(vs, axis=0) for k, vs in v0.items()})


def _smoke3d_cfg() -> Fluid3DConfig:
    return Fluid3DConfig(dt=0.7, buoyancy=0.05, pressure_tol=1e-4,
                         pressure_maxiter=200, warm_start_pressure=True)


def _smoke3d_setup(size: int, n: int, num_train: int, num_val: int,
                   device=None):
    """The direct task's (pde, train, val), shared by `run_smoke3d` and
    `run_smoke3d_ft` (the same seeds, 0 train and 999 val, and config).
    force_amplitude 0.15 (the generator's default) keeps the displacement
    within the max_shift = 1 clip while the zero-force MSE stays well
    above the controller's floor (the JAX package's finding)."""
    domain = Domain3D.create(size, size, size, device=device)
    cfg = _smoke3d_cfg()
    train = generate_forced_smoke3d_dataset(domain, cfg, num_train, n, seed=0)
    val = generate_forced_smoke3d_dataset(domain, cfg, num_val, n, seed=999)
    pde = IncompressibleFluid3DPDE(domain, cfg, control="direct",
                                   unet_levels=2)
    return pde, train, val


def run_smoke3d(workdir: str, size: int = 24, n: int = 8,
                iterations: int = 300, num_train: int = 64,
                num_val: int = 16, batch_size: int = 4,
                e2e_iterations: int | None = None,
                mesh=None, seed: int = 0, resume: bool = False,
                device=None) -> dict:
    """3D smoke control: direct forcing on a size³ volume; grad clip 1.0
    on every stage (unclipped solver-in-the-loop e2e stages diverged in
    the JAX package's runs)."""
    pde, train, val = _smoke3d_setup(size, n, num_train, num_val, device)
    ccfg = CurriculumConfig(n=n, batch_size=batch_size,
                            cfe_iterations=iterations,
                            op_iterations=iterations,
                            e2e_iterations=e2e_iterations or iterations,
                            e2e_lr=1e-4, grad_clip=1.0,
                            force_reg=1e-5, seed=seed)
    return run_curriculum(pde, ccfg, train, val, workdir, mesh=mesh,
                          resume=resume)


def run_smoke3d_ft(workdir: str, init_from: str,
                   force_reg: float = 5e-6,
                   size: int = 24, n: int = 8,
                   num_train: int = 64, num_val: int = 16,
                   batch_size: int = 4,
                   e2e_iterations: int | None = None,
                   mesh=None, seed: int = 0,
                   resume: bool = False, device=None) -> dict:
    """Force-reg annealing fine-tune of a finished smoke3d run: every net
    restored from `init_from` (its ckpt_final, either package's), one more
    e2e stage at a lower force_reg, on `run_smoke3d`'s task and data."""
    pde, train, val = _smoke3d_setup(size, n, num_train, num_val, device)
    ccfg = CurriculumConfig(n=n, batch_size=batch_size,
                            e2e_iterations=e2e_iterations or 600,
                            e2e_lr=5e-5, grad_clip=1.0,
                            force_reg=force_reg, seed=seed)
    return finetune_e2e(pde, ccfg, train, val, workdir, init_from,
                        mesh=mesh, resume=resume)


def _smoke3d_indirect_setup(size: int, n: int, num_train: int, num_val: int,
                            device=None):
    """The plated task's (pde, train, val), shared by
    `run_smoke3d_indirect` and `run_smoke3d_indirect_ft` (the same seeds,
    0 train and 999 val, and config): the plate at size³, buoyancy-only
    control with the inflow as the CFE's seventh channel."""
    domain = Domain3D.create(size, size, size,
                             obstacle_mask=obstacle_plate_3d(size, size, size),
                             device=device)
    cfg = _smoke3d_cfg()
    train = generate_inflow_smoke3d_dataset(domain, cfg, num_train, n, seed=0)
    val = generate_inflow_smoke3d_dataset(domain, cfg, num_val, n, seed=999)
    pde = IncompressibleFluid3DPDE(domain, cfg, control="buoyancy",
                                   with_inflow=True, unet_levels=2)
    return pde, train, val


def run_smoke3d_indirect(workdir: str, size: int = 32, n: int = 16,
                         iterations: int = 400, num_train: int = 128,
                         num_val: int = 16, batch_size: int = 8,
                         e2e_iterations: int | None = None,
                         mesh=None, seed: int = 0, resume: bool = False,
                         device=None) -> dict:
    """3D indirect smoke control: a buoyancy-only CFE steering an
    inflow-driven plume through the plate at size³, n=16. force_reg 3e-5:
    in the JAX package's runs 1e-5 diverged twice (the reg term keeps this
    task stable), so the converged value stays."""
    pde, train, val = _smoke3d_indirect_setup(size, n, num_train, num_val,
                                              device)
    ccfg = CurriculumConfig(n=n, batch_size=batch_size,
                            cfe_iterations=iterations,
                            op_iterations=iterations,
                            e2e_iterations=e2e_iterations or iterations,
                            e2e_lr=1e-4, grad_clip=1.0,
                            force_reg=3e-5, seed=seed)
    return run_curriculum(pde, ccfg, train, val, workdir, mesh=mesh,
                          resume=resume)


def run_smoke3d_indirect_ft(workdir: str, init_from: str,
                            force_reg: float = 1.5e-5,
                            size: int = 32, n: int = 16,
                            num_train: int = 128, num_val: int = 16,
                            batch_size: int = 8,
                            e2e_iterations: int | None = None,
                            mesh=None, seed: int = 0,
                            resume: bool = False, device=None) -> dict:
    """Force-reg annealing fine-tune of a finished smoke3d_indirect run:
    every net restored from `init_from` (its ckpt_final, either
    package's), one more e2e stage at a lower force_reg, which from
    scratch would diverge, on the same task and data."""
    pde, train, val = _smoke3d_indirect_setup(size, n, num_train, num_val,
                                              device)
    ccfg = CurriculumConfig(n=n, batch_size=batch_size,
                            e2e_iterations=e2e_iterations or 600,
                            e2e_lr=5e-5, grad_clip=1.0,
                            force_reg=force_reg, seed=seed)
    return finetune_e2e(pde, ccfg, train, val, workdir, init_from,
                        mesh=mesh, resume=resume)
