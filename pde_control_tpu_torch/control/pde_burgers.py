"""Burgers PDE plugin (BASELINE configs 1-2).

Counterpart of `pde_control_tpu/control/pde_burgers.py :: BurgersPDE`.
State = (B, N) velocity; the observation is the full state (one channel).
The control force is an additive (B, N) tensor applied as +dt·F per step.

The nets are fp32 by default, as in the JAX package. On the card PyTorch
would run fp32 convs in TF32 (`torch.backends.cudnn.allow_tf32` is True by
default), 10 mantissa bits where the JAX package computes in fp32; a
BurgersPDE on a CUDA device with fp32 nets therefore sets
`torch.backends.cudnn.allow_tf32 = False` for the process when it is
built. Every Burgers entry (the CLI, `experiments/burgers.py`,
`compare_burgers`) builds one before its nets run, and the flag is read
when a conv runs, forward and backward, so it holds inside CUDA graphs
too. The 2D paths' nets are bf16 and do not read it.
"""

from __future__ import annotations

import torch

from pde_control_tpu_torch.control.pde_base import PDE
from pde_control_tpu_torch.grids import resolve_device
from pde_control_tpu_torch.models.nets import CFENet, UNet
from pde_control_tpu_torch.physics.burgers import BurgersConfig, burgers_step


class BurgersPDE(PDE):
    dim = 1
    obs_channels = 1

    def __init__(self, cfg: BurgersConfig = BurgersConfig(),
                 dtype=torch.float32, device=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        if self.device.type == "cuda" and dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = False

    # solver ---------------------------------------------------------------
    def step(self, state, force):
        return burgers_step(state, force, self.cfg)

    def observe(self, state):
        return state[..., None]

    def zero_force(self, state):
        return torch.zeros_like(state)

    def force_cost(self, force):
        # Σ_x ‖F‖²·dx — the paper's control-effort regularizer.
        return torch.sum(force ** 2, dim=-1) * self.cfg.dx

    # net glue ---------------------------------------------------------------
    def cfe_inputs(self, state, target_obs):
        return torch.cat([state[..., None], target_obs], dim=-1)

    def force_from_net(self, net_out, state):
        return net_out[..., 0]

    def _padding(self) -> str:
        return "CIRCULAR" if self.cfg.boundary == "periodic" else "SAME"

    def build_cfe(self, generator: torch.Generator | None = None) -> CFENet:
        return CFENet(in_channels=2, out_channels=1, dim=1,
                      padding=self._padding(), dtype=self.dtype,
                      generator=generator)

    def build_op(self, generator: torch.Generator | None = None) -> UNet:
        levels = max(1, min(3, (self.cfg.n // 8).bit_length()))
        return UNet(in_channels=2, out_channels=1, levels=levels,
                    base_features=16, dim=1, padding=self._padding(),
                    dtype=self.dtype, generator=generator)

    # data glue ---------------------------------------------------------------
    def initial_state(self, batch):
        return batch["obs"][:, 0, :, 0]

    def example_state(self, batch_size):
        return torch.zeros((batch_size, self.cfg.n), dtype=torch.float32,
                           device=self.device)
