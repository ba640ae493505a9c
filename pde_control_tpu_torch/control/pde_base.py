"""PDE plugin interface for the control framework.

Counterpart of `pde_control_tpu/control/pde_base.py`: every controlled PDE
provides (a) a differentiable solver step with a force effect, (b) a state
→ observation map, and (c) the glue between network channel tensors and its
state and force types.

Observations are channels-last tensors (B, *spatial, C) — the common
currency of CFE/OP networks and losses. States and forces are PDE-specific:
a tensor (Burgers) or a dataclass of tensors (the fluid); `tree_leaves`
and `tree_map` walk either, as `jax.tree_util` does in the JAX package.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any

import torch

State = Any
Force = Any


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a state or force in order: the tensor itself, or a
    dataclass's fields, nested dataclasses flattened and None skipped."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for f in dataclasses.fields(tree)
            for leaf in tree_leaves(getattr(tree, f.name))]


def tree_map(fn, tree):
    """`tree` with `fn` applied to every tensor (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return dataclasses.replace(tree, **{
        f.name: tree_map(fn, getattr(tree, f.name))
        for f in dataclasses.fields(tree)})


class PDE(abc.ABC):
    """A controllable PDE."""

    #: spatial rank (2 for NS)
    dim: int
    #: channels of observe()'s output
    obs_channels: int
    #: torch device of the solver's tensors and of the nets
    device: torch.device

    # ---------------------------------------------------------------- solver

    @abc.abstractmethod
    def step(self, state: State, force: Force | None) -> State:
        """One differentiable solver step under control force."""

    @abc.abstractmethod
    def observe(self, state: State) -> torch.Tensor:
        """Map state → observation (B, *spatial, obs_channels)."""

    @abc.abstractmethod
    def zero_force(self, state: State) -> Force:
        """A zero control force matching `state`'s batch/shape."""

    @abc.abstractmethod
    def force_cost(self, force: Force) -> torch.Tensor:
        """Per-sample control effort Σ‖F‖² → (B,)."""

    def force_abs_mean(self, force: Force) -> torch.Tensor:
        """Per-sample mean |F| over all force components → (B,) — the
        paper's reported force metric, distinct from the Σ‖F‖²·dxᵈ
        training regularizer."""
        leaves = tree_leaves(force)
        total = sum(torch.sum(torch.abs(l), dim=tuple(range(1, l.ndim)))
                    for l in leaves)
        count = sum(l[0].numel() for l in leaves)
        return total / count

    # ------------------------------------------------------------- net glue

    @abc.abstractmethod
    def cfe_inputs(self, state: State, target_obs: torch.Tensor) -> torch.Tensor:
        """Stack CFE input channels: state fields ⊕ next-frame target obs."""

    @abc.abstractmethod
    def force_from_net(self, net_out: torch.Tensor, state: State) -> Force:
        """Convert CFE output channels → a force (masking, staggering, …)."""

    def op_inputs(self, o_start: torch.Tensor, o_end: torch.Tensor) -> torch.Tensor:
        """Stack OP input channels: obs(t_s) ⊕ obs(t_e)."""
        return torch.cat([o_start, o_end], dim=-1)

    # ------------------------------------------------------- net definitions

    @abc.abstractmethod
    def build_cfe(self, generator: torch.Generator | None = None) -> torch.nn.Module:
        """Default CFE module for this PDE."""

    @abc.abstractmethod
    def build_op(self, generator: torch.Generator | None = None) -> torch.nn.Module:
        """Default OP module for one hierarchy level."""

    # ------------------------------------------------------------- data glue

    @abc.abstractmethod
    def initial_state(self, batch: dict) -> State:
        """Build the full initial state from a batch of tensors."""

    @abc.abstractmethod
    def example_state(self, batch_size: int) -> State:
        """A zeros state of this PDE's shapes."""
