"""Dataset generation: batched rollouts of the port's physics.

Counterpart of `pde_control_tpu/data/generate.py`:
* Burgers (BASELINE configs 1-2, `random_burgers_states`,
  `generate_burgers_dataset`): smooth periodic states (superposed
  sinusoids) evolved under a withheld random forcing, constant in time,
  so that endpoint reconstruction needs control;
* the indirect-smoke data (`random_inflow`, `random_smooth_field_2d`,
  `generate_inflow_smoke_dataset`, BASELINE config 4): an inflow-driven
  plume steered by a withheld random buoyancy-modulation field, so that
  the target frame is not the natural evolution;
* natural plumes from Gaussian blobs (`random_smoke_blobs`,
  `generate_smoke_dataset`);
* forced smoke (`generate_forced_smoke_dataset`, configs 3 and 5): soft
  rasterized shapes (`random_shape_densities`: circles and boxes; the
  withheld families `random_cross_densities` and `random_ring_densities`)
  or blobs, pushed by withheld random smooth direct forces.

Randomness comes from a `torch.Generator` seeded by `seed`. The JAX
package draws with `jax.random`, whose bits torch cannot reproduce, so each
random function is split into its draws (`*_draws`) and a deterministic
construction from them (`*_from_draws`); fed the same draws, the
constructions match the JAX package's. Draws are made on the CPU; the
constructions and the unfused rollouts run on the domain's device, with
the configuration's pressure solve (on the card 'auto' takes K1 where
there are obstacles and the exact spectral solve in an empty closed box;
'cuda' takes K1 everywhere).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pde_control_tpu_torch.data.scene import TrajectoryDataset
from pde_control_tpu_torch.geom import Box, Sphere, rasterize, union
from pde_control_tpu_torch.grids import (
    Domain2D,
    Staggered2D,
    centered_to_x_faces,
    centered_to_y_faces,
    resolve_device,
)
from pde_control_tpu_torch.physics.burgers import BurgersConfig, burgers_step
from pde_control_tpu_torch.physics.fluid import FluidConfig, FluidState, fluid_step


# ------------------------------------------------------------ Burgers (B, N)

def burgers_draws(gen: torch.Generator, batch: int, modes: int = 3):
    """Unit normal amplitudes and phases in [0, 2π), (B, M) each."""
    amps = torch.randn((batch, modes), generator=gen)
    phases = torch.rand((batch, modes), generator=gen) * (2 * math.pi)
    return amps, phases


def burgers_from_draws(amps: torch.Tensor, phases: torch.Tensor, n: int,
                       amplitude: float = 1.0) -> torch.Tensor:
    """Smooth periodic fields (B, N): Σ_k amplitude·a_k/k · sin(k·x + φ_k)
    over the wavenumbers k = 1..M, x = 2πi/N."""
    dev = amps.device
    ks = torch.arange(1, amps.shape[1] + 1, dtype=torch.float32, device=dev)
    amps = amps * amplitude / ks[None]
    x = torch.arange(n, dtype=torch.float32, device=dev) * (2 * math.pi / n)
    waves = torch.sin(ks[None, :, None] * x[None, None, :] + phases[..., None])
    return torch.sum(amps[..., None] * waves, dim=1)


def random_burgers_states(gen: torch.Generator, batch: int, n: int,
                          modes: int = 3, amplitude: float = 1.0,
                          device=None) -> torch.Tensor:
    """Randomized smooth periodic fields: superposed sinusoids (B, N)."""
    amps, phases = burgers_draws(gen, batch, modes)
    dev = resolve_device(device)
    return burgers_from_draws(amps.to(dev), phases.to(dev), n,
                              amplitude=amplitude)


def generate_burgers_dataset(cfg: BurgersConfig, num: int, n_steps: int,
                             seed: int = 0, force_amplitude: float = 0.25,
                             batch: int = 64, device=None
                             ) -> TrajectoryDataset:
    """Forced Burgers trajectories → TrajectoryDataset of obs (num,
    n_steps + 1, N, 1). Each chunk of `batch` draws its initial states,
    then its forces (amplitude `force_amplitude`), and rolls out on
    `device` (the card unless given); the force is not stored."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    chunks = []
    remaining = num
    while remaining > 0:
        b = min(batch, remaining)
        u0_draws, f_draws = (burgers_draws(gen, b) for _ in range(2))
        u = burgers_from_draws(*(d.to(dev) for d in u0_draws), cfg.n)
        force = burgers_from_draws(*(d.to(dev) for d in f_draws), cfg.n,
                                   amplitude=force_amplitude)
        frames = [u]
        with torch.no_grad():
            for _ in range(n_steps):
                u = burgers_step(u, force, cfg)
                frames.append(u)
        traj = torch.stack(frames, dim=1)  # (b, T + 1, N)
        chunks.append(traj.cpu().numpy()[..., None])
        remaining -= b
    return TrajectoryDataset(np.concatenate(chunks, axis=0))


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


# ------------------------------------------------- blobs and shapes (B, H, W)

def _positions(gen: torch.Generator, batch: int, h: int, w: int,
               margin: int) -> torch.Tensor:
    """Centres (B, 2) as (y, x), uniform in [margin, h - margin) ×
    [margin, w - margin)."""
    hi = torch.tensor([h - margin, w - margin], dtype=torch.float32)
    return margin + torch.rand((batch, 2), generator=gen) * (hi - margin)


def _uniform(gen: torch.Generator, batch: int, lo: float, hi: float
             ) -> torch.Tensor:
    """(B, 1, 1) uniform in [lo, hi)."""
    return lo + torch.rand((batch, 1, 1), generator=gen) * (hi - lo)


def _margin(margin: int, h: int, w: int) -> int:
    # A margin of 8-12 on a 16² grid would pin every centre to the middle
    # (and invert the range below 16): clamp it as the JAX package does.
    return min(margin, h // 4, w // 4)


def _centres(pos: torch.Tensor):
    return pos[:, 0, None, None], pos[:, 1, None, None]


def blob_draws(gen: torch.Generator, batch: int, h: int, w: int,
               sigma_range=(4.0, 8.0), margin: int = 8):
    """Blob centres (B, 2) and widths (B, 1, 1)."""
    return (_positions(gen, batch, h, w, _margin(margin, h, w)),
            _uniform(gen, batch, *sigma_range))


def blobs_from_draws(pos: torch.Tensor, sig: torch.Tensor, h: int, w: int
                     ) -> torch.Tensor:
    """Gaussian density blobs (B, H, W) of peak 1."""
    yy = torch.arange(h, dtype=torch.float32, device=pos.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=pos.device)[None, None, :]
    cy, cx = _centres(pos)
    return torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))


def random_smoke_blobs(gen: torch.Generator, batch: int, h: int, w: int,
                       sigma_range=(4.0, 8.0), margin: int = 8) -> torch.Tensor:
    """Random Gaussian density blobs (B, H, W), peak 1."""
    return blobs_from_draws(*blob_draws(gen, batch, h, w, sigma_range, margin),
                            h, w)


def shape_draws(gen: torch.Generator, batch: int, h: int, w: int,
                size_range=(5.0, 10.0), margin: int = 12):
    """Centres (B, 2), half-sizes r and box aspect ratios (B, 1, 1), and
    whether each shape is a circle (B, 1, 1) bool, even odds."""
    pos = _positions(gen, batch, h, w, _margin(margin, h, w))
    r = _uniform(gen, batch, *size_range)
    aspect = _uniform(gen, batch, 0.6, 1.6)
    return pos, r, aspect, torch.rand((batch, 1, 1), generator=gen) < 0.5


def shapes_from_draws(pos, r, aspect, is_circle, h: int, w: int,
                      smooth: float = 1.5) -> torch.Tensor:
    """Circles of radius r, or boxes of half-height r and half-width
    r·aspect, rasterized with a soft edge (B, H, W): the shape-transition
    task's content."""
    cy, cx = _centres(pos)
    circles = rasterize(Sphere(cy=cy, cx=cx, r=r), h, w, smooth=smooth,
                        device=pos.device)
    boxes = rasterize(Box(y0=cy - r, x0=cx - r * aspect, y1=cy + r,
                          x1=cx + r * aspect), h, w, smooth=smooth,
                      device=pos.device)
    return torch.where(is_circle, circles, boxes)


def random_shape_densities(gen: torch.Generator, batch: int, h: int, w: int,
                           size_range=(5.0, 10.0), margin: int = 12,
                           smooth: float = 1.5) -> torch.Tensor:
    """Random soft circles and boxes (B, H, W)."""
    return shapes_from_draws(*shape_draws(gen, batch, h, w, size_range,
                                          margin), h, w, smooth=smooth)


def cross_draws(gen: torch.Generator, batch: int, h: int, w: int,
                size_range=(5.0, 10.0), margin: int = 12):
    """Centres (B, 2), arm lengths and thickness fractions (B, 1, 1)."""
    pos = _positions(gen, batch, h, w, _margin(margin, h, w))
    arm = _uniform(gen, batch, *size_range)
    return pos, arm, _uniform(gen, batch, 0.25, 0.45)


def crosses_from_draws(pos, arm, thick_frac, h: int, w: int,
                       smooth: float = 1.5) -> torch.Tensor:
    """Crosses (the union of two elongated boxes) with a soft edge (B, H,
    W): a shape family withheld from training, for generalization."""
    cy, cx = _centres(pos)
    thick = arm * thick_frac
    cross = union(
        Box(y0=cy - arm, x0=cx - thick, y1=cy + arm, x1=cx + thick),
        Box(y0=cy - thick, x0=cx - arm, y1=cy + thick, x1=cx + arm))
    return rasterize(cross, h, w, smooth=smooth, device=pos.device)


def random_cross_densities(gen: torch.Generator, batch: int, h: int, w: int,
                           size_range=(5.0, 10.0), margin: int = 12,
                           smooth: float = 1.5) -> torch.Tensor:
    """Random soft crosses (B, H, W)."""
    return crosses_from_draws(*cross_draws(gen, batch, h, w, size_range,
                                           margin), h, w, smooth=smooth)


def ring_draws(gen: torch.Generator, batch: int, h: int, w: int,
               size_range=(6.0, 10.0), margin: int = 12):
    """Centres (B, 2), outer radii and inner-radius fractions (B, 1, 1)."""
    pos = _positions(gen, batch, h, w, _margin(margin, h, w))
    r_out = _uniform(gen, batch, *size_range)
    return pos, r_out, _uniform(gen, batch, 0.4, 0.65)


def rings_from_draws(pos, r_out, in_frac, h: int, w: int,
                     smooth: float = 1.5) -> torch.Tensor:
    """Rings (outer disc minus inner disc, clipped to [0, 1]) with a soft
    edge (B, H, W): the second withheld family, of hollow topology."""
    cy, cx = _centres(pos)
    outer = rasterize(Sphere(cy=cy, cx=cx, r=r_out), h, w, smooth=smooth,
                      device=pos.device)
    inner = rasterize(Sphere(cy=cy, cx=cx, r=r_out * in_frac), h, w,
                      smooth=smooth, device=pos.device)
    return torch.clamp(outer - inner, 0.0, 1.0)


def random_ring_densities(gen: torch.Generator, batch: int, h: int, w: int,
                          size_range=(6.0, 10.0), margin: int = 12,
                          smooth: float = 1.5) -> torch.Tensor:
    """Random soft rings (B, H, W)."""
    return rings_from_draws(*ring_draws(gen, batch, h, w, size_range, margin),
                            h, w, smooth=smooth)


# init name -> (draws, construction). 'crosses' and 'rings' are withheld
# from every training run ('shapes' = circles and boxes); they exist for
# generalization evals and the rings fine-tune.
INITS = {"shapes": (shape_draws, shapes_from_draws),
         "blobs": (blob_draws, blobs_from_draws),
         "crosses": (cross_draws, crosses_from_draws),
         "rings": (ring_draws, rings_from_draws)}


# ------------------------------------------------ natural and forced smoke

def smoke_rollout(domain: Domain2D, cfg: FluidConfig, density0: torch.Tensor,
                  n_steps: int, force: Staggered2D | None = None
                  ) -> torch.Tensor:
    """n_steps from rest under a force constant in time (or none). Returns
    the densities (n_steps + 1, B, H, W), frame 0 the initial one."""
    h, w = domain.grid_shape
    with torch.no_grad():
        state = FluidState(
            velocity=Staggered2D.zeros(density0.shape[0], h, w,
                                       device=density0.device),
            density=density0)
        frames = [density0]
        for _ in range(n_steps):
            state = fluid_step(state, domain, cfg, force=force)
            frames.append(state.density)
    return torch.stack(frames)


def _from_rest(domain: Domain2D, cfg: FluidConfig, num: int, n_steps: int,
               seed: int, batch: int, init: str,
               force_amplitude: float | None) -> TrajectoryDataset:
    """Rollouts from rest of `init`'s densities, in batches, under random
    smooth direct forces of `force_amplitude` (None: no force): obs (num,
    n_steps + 1, H, W, 1) and the zero initial velocity (vy0, vx0)."""
    draw, build = INITS[init]
    h, w = domain.grid_shape
    dev = domain.device
    gen = torch.Generator().manual_seed(seed)
    chunks = []
    remaining = num
    while remaining > 0:
        b = min(batch, remaining)
        d0 = build(*(d.to(dev) for d in draw(gen, b, h, w)), h, w)
        force = None
        if force_amplitude is not None:
            fy, fx = (smooth_field_from_draws(
                *(d.to(dev) for d in smooth_field_draws(gen, b)), h, w,
                amplitude=force_amplitude) for _ in range(2))
            force = Staggered2D(vy=centered_to_y_faces(fy),
                                vx=centered_to_x_faces(fx))
        traj = smoke_rollout(domain, cfg, d0, n_steps, force)
        chunks.append(np.moveaxis(traj.cpu().numpy(), 0, 1)[..., None])
        remaining -= b
    return TrajectoryDataset(np.concatenate(chunks, axis=0),
                             vy0=np.zeros((num, h + 1, w), np.float32),
                             vx0=np.zeros((num, h, w + 1), np.float32))


def generate_smoke_dataset(domain: Domain2D, cfg: FluidConfig, num: int,
                           n_steps: int, seed: int = 0, batch: int = 8
                           ) -> TrajectoryDataset:
    """Natural buoyant-plume trajectories from random blobs at rest: obs
    (num, n_steps + 1, H, W, 1) and the zero initial velocity (vy0, vx0)."""
    return _from_rest(domain, cfg, num, n_steps, seed, batch, "blobs", None)


def generate_forced_smoke_dataset(
    domain: Domain2D,
    cfg: FluidConfig,
    num: int,
    n_steps: int,
    seed: int = 0,
    force_amplitude: float = 0.1,
    batch: int = 8,
    init: str = "shapes",  # a key of INITS
) -> TrajectoryDataset:
    """Shape-transition style trajectories (BASELINE configs 3 and 5): the
    initial densities of `init` pushed by random smooth direct forces (fy,
    fx centred, moved to the faces), constant in time and withheld from the
    controller, so that endpoint reconstruction needs control while staying
    reachable with moderate force. Returns obs (num, n_steps + 1, H, W, 1)
    and the zero initial velocity (vy0, vx0)."""
    return _from_rest(domain, cfg, num, n_steps, seed, batch, init,
                      force_amplitude)
