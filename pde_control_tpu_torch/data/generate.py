"""Dataset generation: batched rollouts of the port's physics.

Counterpart of the inflow-smoke part of `pde_control_tpu/data/generate.py`
(`random_inflow`, `random_smooth_field_2d`, `generate_inflow_smoke_dataset`):
an inflow-driven plume steered by a withheld random buoyancy-modulation
field, so that the target frame is not the natural evolution.

Randomness comes from a `torch.Generator` seeded by `seed`. The JAX
package draws with `jax.random`, whose bits torch cannot reproduce, so each
random function is split into its draws (`*_draws`) and a deterministic
construction from them (`inflow_from_draws`, `smooth_field_from_draws`);
fed the same draws, the constructions match the JAX package's.

The other generators (shapes, rings, crosses, forced smoke, Burgers) are
not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pde_control_tpu_torch.data.scene import TrajectoryDataset
from pde_control_tpu_torch.grids import Domain2D, Staggered2D, centered_to_y_faces
from pde_control_tpu_torch.physics.fluid import FluidConfig, FluidState, fluid_step


def inflow_draws(gen: torch.Generator, batch: int, w: int,
                 x_range: tuple = (0.15, 0.85)) -> torch.Tensor:
    """The sources' x positions (B, 1, 1), uniform in x_range · w."""
    u = torch.rand((batch, 1, 1), generator=gen)
    return x_range[0] * w + u * ((x_range[1] - x_range[0]) * w)


def inflow_from_draws(xs: torch.Tensor, h: int, w: int, rate: float = 0.08,
                      sigma: float = 2.0, y0: float = 4.0) -> torch.Tensor:
    """Continuous smoke sources (B, H, W): a Gaussian emitter of strength
    `rate` at height y0 and the drawn x positions."""
    yy = torch.arange(h, dtype=torch.float32, device=xs.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=xs.device)[None, None, :]
    r2 = (yy - y0) ** 2 + (xx - xs) ** 2
    return rate * torch.exp(-r2 / (2 * sigma ** 2))


def random_inflow(gen: torch.Generator, batch: int, h: int, w: int,
                  rate: float = 0.08, sigma: float = 2.0, y0: float = 4.0,
                  x_range: tuple = (0.15, 0.85)) -> torch.Tensor:
    """Random continuous smoke sources near the bottom wall (B, H, W)."""
    return inflow_from_draws(inflow_draws(gen, batch, w, x_range), h, w,
                             rate=rate, sigma=sigma, y0=y0)


def smooth_field_draws(gen: torch.Generator, batch: int, modes: int = 3):
    """Unit normal amplitudes (B, M, M) and phases in [0, 2π) for y and x
    (B, M, 1 each)."""
    amps = torch.randn((batch, modes, modes), generator=gen)
    phy = torch.rand((batch, modes, 1), generator=gen) * (2 * math.pi)
    phx = torch.rand((batch, modes, 1), generator=gen) * (2 * math.pi)
    return amps, phy, phx


def smooth_field_from_draws(amps: torch.Tensor, phy: torch.Tensor,
                            phx: torch.Tensor, h: int, w: int,
                            amplitude: float = 1.0) -> torch.Tensor:
    """Smooth (B, H, W) field from low-frequency sine modes: amps (B, M, M)
    unit normal, phases (B, M, 1)."""
    modes = amps.shape[1]
    dev = amps.device
    ky = torch.arange(1, modes + 1, dtype=torch.float32, device=dev)
    y = torch.arange(h, dtype=torch.float32, device=dev) * (math.pi / h)
    x = torch.arange(w, dtype=torch.float32, device=dev) * (math.pi / w)
    sy = torch.sin(ky[None, :, None] * y[None, None, :] + phy)  # (B, M, H)
    sx = torch.sin(ky[None, :, None] * x[None, None, :] + phx)  # (B, M, W)
    return torch.einsum("bmy,bnx,bmn->byx", sy, sx, amps * amplitude) / modes


def random_smooth_field_2d(gen: torch.Generator, batch: int, h: int, w: int,
                           modes: int = 3, amplitude: float = 1.0
                           ) -> torch.Tensor:
    """Random smooth (B, H, W) fields from low-frequency Fourier modes."""
    return smooth_field_from_draws(*smooth_field_draws(gen, batch, modes),
                                   h, w, amplitude=amplitude)


def inflow_smoke_rollout(domain: Domain2D, cfg: FluidConfig,
                         inflow: torch.Tensor, b_field: torch.Tensor,
                         n_steps: int, warmup: int = 8):
    """One batch of the indirect-smoke task: `warmup` natural steps from
    rest with the sources on, then n_steps under the buoyancy modulation
    b·ρ on y-faces. Returns the densities (n_steps + 1, B, H, W), frame 0
    the post-warm-up state, and that state's velocity."""
    h, w = domain.grid_shape
    with torch.no_grad():
        state = FluidState(
            velocity=Staggered2D.zeros(inflow.shape[0], h, w,
                                       device=inflow.device),
            density=torch.zeros_like(inflow), inflow=inflow)
        for _ in range(warmup):
            state = fluid_step(state, domain, cfg)
        frames, vel0 = [state.density], state.velocity
        for _ in range(n_steps):
            force = Staggered2D(
                vy=centered_to_y_faces(b_field * state.density),
                vx=torch.zeros_like(state.velocity.vx))
            state = fluid_step(state, domain, cfg, force=force)
            frames.append(state.density)
    return torch.stack(frames), vel0


def generate_inflow_smoke_dataset(
    domain: Domain2D,
    cfg: FluidConfig,
    num: int,
    n_steps: int,
    seed: int = 0,
    control_amplitude: float = 0.6,
    batch: int = 8,
    warmup: int = 8,
    inflow_kwargs: dict | None = None,
) -> TrajectoryDataset:
    """The smoke benchmark's data: an inflow-driven plume rising through
    obstacles, steered by a withheld random buoyancy-modulation field b(x)
    applied as the buoyancy-mode CFE applies control (vy += dt·b·ρ on
    y-faces). Zero force cannot reproduce the target frame, which stays
    reachable by the controller's force parameterization. Runs on the
    domain's device; the draws come from a CPU generator seeded by `seed`.

    Returns obs (num, n_steps + 1, H, W, 1) with extras vy0, vx0 (the
    post-warm-up velocity) and inflow."""
    h, w = domain.grid_shape
    kw = dict(inflow_kwargs or {})
    x_range = kw.pop("x_range", (0.15, 0.85))
    gen = torch.Generator().manual_seed(seed)
    chunks, inflows, vy0s, vx0s = [], [], [], []
    remaining = num
    while remaining > 0:
        b = min(batch, remaining)
        xs = inflow_draws(gen, b, w, x_range)
        draws = smooth_field_draws(gen, b)
        dev = domain.device
        inflow = inflow_from_draws(xs.to(dev), h, w, **kw)
        b_field = smooth_field_from_draws(*(d.to(dev) for d in draws), h, w,
                                          amplitude=control_amplitude)
        traj, vel0 = inflow_smoke_rollout(domain, cfg, inflow, b_field,
                                          n_steps, warmup)
        chunks.append(np.moveaxis(traj.cpu().numpy(), 0, 1)[..., None])
        inflows.append(inflow.cpu().numpy())
        vy0s.append(vel0.vy.cpu().numpy())
        vx0s.append(vel0.vx.cpu().numpy())
        remaining -= b
    return TrajectoryDataset(np.concatenate(chunks, axis=0),
                             vy0=np.concatenate(vy0s, axis=0),
                             vx0=np.concatenate(vx0s, axis=0),
                             inflow=np.concatenate(inflows, axis=0))
