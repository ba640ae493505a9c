"""3D smoke control: buoyant blobs in a closed volume pushed by withheld
random forcing, controlled by the dim=3 CFE/OP stack through the staged
curriculum.

Counterpart of `pde_control_tpu/experiments/smoke3d.py`, its obstacle-free
half: `random_blobs_3d`, `random_smooth_field_3d`,
`generate_forced_smoke3d_dataset`, `run_smoke3d` and `run_smoke3d_ft`.
The box has no obstacles, so every pressure solve is the exact 3D
spectral solve (no host check of a CG loop), and `progress_multi` captures
each stage's step as one CUDA graph, as in 2D. The plated indirect task
(`obstacle_plate_3d`, `random_inflow_3d`, `smoke3d_indirect*`) is not
ported yet: its CG asks the host once a trip whether a sample is still
active, which a CUDA graph cannot record.

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
