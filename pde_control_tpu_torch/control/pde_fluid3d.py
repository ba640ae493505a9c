"""3D incompressible-flow PDE plugin: the CFE/OP control stack on volumes.

Counterpart of `pde_control_tpu/control/pde_fluid3d.py ::
IncompressibleFluid3DPDE`, with the contract of the 2D
`IncompressibleFluidPDE`: observation = density, one channel; control
``direct`` (a 3-channel centered force, resampled to the faces) or
``buoyancy`` (a scalar field b(x) times the density on z-faces, z up); an
optional static ``force_mask`` (D, H, W); with ``with_inflow`` the batches
carry an ``inflow`` that the state holds and the CFE sees as a seventh
input channel. The nets are the 2D ones at dim=3 (`models/nets.py`: flax's
names, cuDNN's `conv3d`), bf16 by default; the physics stays fp32.
"""

from __future__ import annotations

import torch

from pde_control_tpu_torch.control.pde_base import PDE
from pde_control_tpu_torch.grids3d import (
    Domain3D,
    Staggered3D,
    centered_to_x_faces_3d,
    centered_to_y_faces_3d,
    centered_to_z_faces,
)
from pde_control_tpu_torch.models.nets import CFENet, UNet
from pde_control_tpu_torch.physics.fluid3d import (
    Fluid3DConfig,
    FluidState3D,
    fluid3d_step,
)


class IncompressibleFluid3DPDE(PDE):
    dim = 3
    obs_channels = 1

    def __init__(
        self,
        domain: Domain3D,
        cfg: Fluid3DConfig = Fluid3DConfig(),
        control: str = "direct",          # 'direct' | 'buoyancy'
        force_mask=None,  # (D, H, W), 1 = forcing allowed; numpy or tensor
        unet_levels: int = 2,
        with_inflow: bool = False,
        dtype=torch.bfloat16,  # net compute dtype; physics stays fp32
    ):
        if control not in ("direct", "buoyancy"):
            raise ValueError(f"unknown control mode {control!r}")
        self.domain = domain
        self.cfg = cfg
        self.control = control
        self.force_mask = None if force_mask is None else torch.as_tensor(
            force_mask, dtype=torch.float32, device=domain.device)
        self.unet_levels = unet_levels
        self.with_inflow = with_inflow
        self.dtype = dtype

    @property
    def device(self) -> torch.device:
        return self.domain.device

    # physics glue -----------------------------------------------------------
    def step(self, state: FluidState3D, force: Staggered3D | None
             ) -> FluidState3D:
        return fluid3d_step(state, self.domain, self.cfg, force=force)

    def observe(self, state: FluidState3D) -> torch.Tensor:
        return state.density[..., None]

    def zero_force(self, state: FluidState3D) -> Staggered3D:
        v = state.velocity
        return Staggered3D(vz=torch.zeros_like(v.vz), vy=torch.zeros_like(v.vy),
                           vx=torch.zeros_like(v.vx))

    def force_cost(self, force: Staggered3D) -> torch.Tensor:
        dx3 = self.domain.dx ** 3
        return (torch.sum(force.vz ** 2, dim=(1, 2, 3))
                + torch.sum(force.vy ** 2, dim=(1, 2, 3))
                + torch.sum(force.vx ** 2, dim=(1, 2, 3))) * dx3

    # net glue ---------------------------------------------------------------
    def cfe_inputs(self, state: FluidState3D,
                   target_obs: torch.Tensor) -> torch.Tensor:
        vz_c, vy_c, vx_c = state.velocity.at_centers()
        mask = self.domain.fluid_mask[None].expand_as(state.density)
        chans = [state.density, vz_c, vy_c, vx_c, target_obs[..., 0], mask]
        if self.with_inflow:
            chans.append(state.inflow)
        return torch.stack(chans, dim=-1)

    def force_from_net(self, net_out: torch.Tensor,
                       state: FluidState3D) -> Staggered3D:
        if self.force_mask is not None:
            net_out = net_out * self.force_mask[None, :, :, :, None]
        if self.control == "buoyancy":
            # Upward force ∝ smoke density, modulated by the net's scalar
            # field (indirect control; z+ is up).
            v = state.velocity
            return Staggered3D(
                vz=centered_to_z_faces(net_out[..., 0] * state.density),
                vy=torch.zeros_like(v.vy), vx=torch.zeros_like(v.vx))
        return Staggered3D(vz=centered_to_z_faces(net_out[..., 0]),
                           vy=centered_to_y_faces_3d(net_out[..., 1]),
                           vx=centered_to_x_faces_3d(net_out[..., 2]))

    def build_cfe(self, generator: torch.Generator | None = None) -> CFENet:
        out = 1 if self.control == "buoyancy" else 3
        return CFENet(in_channels=7 if self.with_inflow else 6,
                      out_channels=out, dtype=self.dtype, generator=generator,
                      dim=3)

    def build_op(self, generator: torch.Generator | None = None) -> UNet:
        return UNet(in_channels=3, out_channels=1, levels=self.unet_levels,
                    base_features=16, dtype=self.dtype, generator=generator,
                    dim=3)

    def op_inputs(self, o_start, o_end):
        mask = self.domain.fluid_mask[None, :, :, :, None].expand_as(o_start)
        return torch.cat([o_start, o_end, mask], dim=-1)

    # data glue ---------------------------------------------------------------
    def initial_state(self, batch: dict) -> FluidState3D:
        d, h, w = self.domain.grid_shape
        obs = batch["obs"]
        b = obs.shape[0]
        if "vz0" in batch:
            vel = Staggered3D(vz=batch["vz0"], vy=batch["vy0"], vx=batch["vx0"])
        else:
            vel = Staggered3D.zeros(b, d, h, w, device=obs.device)
        inflow = None
        if self.with_inflow:
            if "inflow" not in batch:
                raise ValueError("with_inflow=True but batch has no 'inflow'")
            inflow = batch["inflow"]
        pressure = (torch.zeros((b, d, h, w), dtype=obs.dtype,
                                device=obs.device)
                    if self.cfg.warm_start_pressure else None)
        return FluidState3D(velocity=vel, density=obs[:, 0, ..., 0],
                            inflow=inflow, pressure=pressure)

    def example_state(self, batch_size: int) -> FluidState3D:
        d, h, w = self.domain.grid_shape
        return FluidState3D.zeros(batch_size, d, h, w,
                                  with_inflow=self.with_inflow,
                                  device=self.domain.device)
