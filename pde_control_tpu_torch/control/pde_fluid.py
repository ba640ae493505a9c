"""Incompressible-flow PDE plugin.

Counterpart of `pde_control_tpu/control/pde_fluid.py ::
IncompressibleFluidPDE`. State = FluidState (MAC velocity + density).
Observation = the density field, one channel.

Two control modes:
  * ``direct``   — the CFE outputs a 2-channel centered force field,
    resampled to faces and applied as +dt·F (shape transition).
  * ``buoyancy`` — indirect control: the CFE outputs a scalar field b(x);
    the force is an extra buoyancy term b·ρ on y-faces only.

An optional static ``force_mask`` (H, W) restricts where forces may act.
With ``with_inflow`` the batches carry a per-sample ``inflow`` (a
continuous smoke source), which the CFE sees as a sixth input channel.
"""

from __future__ import annotations

import torch

from pde_control_tpu_torch.control.pde_base import PDE
from pde_control_tpu_torch.grids import (
    Domain2D,
    Staggered2D,
    centered_to_x_faces,
    centered_to_y_faces,
)
from pde_control_tpu_torch.models.nets import CFENet, UNet
from pde_control_tpu_torch.physics.fluid import FluidConfig, FluidState, fluid_step


class IncompressibleFluidPDE(PDE):
    dim = 2
    obs_channels = 1

    def __init__(
        self,
        domain: Domain2D,
        cfg: FluidConfig = FluidConfig(),
        control: str = "direct",          # 'direct' | 'buoyancy'
        force_mask=None,  # (H, W), 1 = forcing allowed; numpy or tensor
        unet_levels: int = 4,
        cfe_features: tuple | None = None,  # conv widths; None = CFENet default
        op_base_features: int = 16,
        with_inflow: bool = False,  # batches carry 'inflow' (B, H, W)
        dtype=torch.bfloat16,  # net compute dtype; params and physics are fp32
        conv_impl: str = "xla",  # models/nets.py :: Conv; 'cuda' routes the
        # 3x3 stride-1 convs to the hand-written kernels (ops/cuda_conv.py)
    ):
        if control not in ("direct", "buoyancy"):
            raise ValueError(f"unknown control mode {control!r}")
        self.domain = domain
        self.cfg = cfg
        self.control = control
        self.force_mask = None if force_mask is None else torch.as_tensor(
            force_mask, dtype=torch.float32, device=domain.device)
        self.unet_levels = unet_levels
        self.cfe_features = cfe_features
        self.op_base_features = op_base_features
        self.with_inflow = with_inflow
        self.dtype = dtype
        self.conv_impl = conv_impl

    # solver ---------------------------------------------------------------
    def step(self, state: FluidState, force: Staggered2D | None) -> FluidState:
        return fluid_step(state, self.domain, self.cfg, force=force)

    def observe(self, state: FluidState) -> torch.Tensor:
        return state.density[..., None]

    def zero_force(self, state: FluidState) -> Staggered2D:
        return Staggered2D(vy=torch.zeros_like(state.velocity.vy),
                           vx=torch.zeros_like(state.velocity.vx))

    def force_cost(self, force: Staggered2D) -> torch.Tensor:
        dx2 = self.domain.dx * self.domain.dx
        return (torch.sum(force.vy ** 2, dim=(1, 2))
                + torch.sum(force.vx ** 2, dim=(1, 2))) * dx2

    # net glue ---------------------------------------------------------------
    def cfe_inputs(self, state: FluidState, target_obs: torch.Tensor) -> torch.Tensor:
        vy_c, vx_c = state.velocity.at_centers()
        mask = self.domain.fluid_mask[None].expand_as(state.density)
        chans = [state.density, vy_c, vx_c, target_obs[..., 0], mask]
        if self.with_inflow:
            chans.append(state.inflow)
        return torch.stack(chans, dim=-1)

    def force_from_net(self, net_out: torch.Tensor, state: FluidState) -> Staggered2D:
        if self.force_mask is not None:
            net_out = net_out * self.force_mask[None, :, :, None]
        if self.control == "buoyancy":
            # Upward force ∝ smoke density, modulated by the net's scalar
            # field — forces exist only where smoke is.
            b_at_y = centered_to_y_faces(net_out[..., 0] * state.density)
            return Staggered2D(vy=b_at_y, vx=torch.zeros_like(state.velocity.vx))
        return Staggered2D(vy=centered_to_y_faces(net_out[..., 0]),
                           vx=centered_to_x_faces(net_out[..., 1]))

    def build_cfe(self, generator: torch.Generator | None = None) -> CFENet:
        out = 1 if self.control == "buoyancy" else 2
        kw = {"features": tuple(self.cfe_features)} if self.cfe_features else {}
        return CFENet(in_channels=6 if self.with_inflow else 5,
                      out_channels=out, dtype=self.dtype,
                      generator=generator, conv_impl=self.conv_impl, **kw)

    def build_op(self, generator: torch.Generator | None = None) -> UNet:
        return UNet(in_channels=3, out_channels=1, levels=self.unet_levels,
                    base_features=self.op_base_features, dtype=self.dtype,
                    generator=generator, conv_impl=self.conv_impl)

    def op_inputs(self, o_start, o_end):
        mask = self.domain.fluid_mask[None, :, :, None].expand_as(o_start)
        return torch.cat([o_start, o_end, mask], dim=-1)

    # data glue ---------------------------------------------------------------
    def initial_state(self, batch: dict) -> FluidState:
        h, w = self.domain.grid_shape
        obs = batch["obs"]
        b = obs.shape[0]
        if "vy0" in batch:
            vel = Staggered2D(vy=batch["vy0"], vx=batch["vx0"])
        else:
            vel = Staggered2D.zeros(b, h, w, device=obs.device)
        inflow = None
        if self.with_inflow:
            if "inflow" not in batch:
                raise ValueError("with_inflow=True but batch has no 'inflow'")
            inflow = batch["inflow"]
        # A zero pressure seed makes every step warm-start its projection
        # from the previous step's solution.
        pressure = (torch.zeros((b, h, w), dtype=obs.dtype, device=obs.device)
                    if self.cfg.warm_start_pressure else None)
        return FluidState(velocity=vel, density=obs[:, 0, :, :, 0],
                          inflow=inflow, pressure=pressure)

    def example_state(self, batch_size: int) -> FluidState:
        h, w = self.domain.grid_shape
        return FluidState.zeros(batch_size, h, w, with_inflow=self.with_inflow,
                                device=self.domain.device)
