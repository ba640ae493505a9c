"""ControlTraining — the training harness, main-path subset.

Counterpart of `pde_control_tpu/control/training.py :: ControlTraining`
for the 'chain' and 'staggered' sequence classes: networks named 'CFE' and
'OP{span}', frozen networks that get no update, Adam, and updates skipped
when a gradient is not finite (`optax.apply_if_finite`: the whole update,
Adam's moments and step count included, is skipped and counted).

`torch.optim.Adam` computes `optax.adam`'s update (same β₁, β₂, ε and bias
correction). Only trainable networks carry gradients, so the finiteness
check reads their gradients; in the JAX package it also read the frozen
networks' gradients, which come from the same loss.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from pde_control_tpu_torch.control.pde_base import PDE
from pde_control_tpu_torch.control.sequences import run_chain, staggered_targets

SEQUENCE_CLASSES = ("chain", "staggered")


def _time_major(obs: torch.Tensor) -> torch.Tensor:
    """(B, T, *s, C) → (T, B, *s, C)."""
    return torch.movedim(obs, 1, 0)


class ControlTraining:
    def __init__(
        self,
        n: int,
        pde: PDE,
        trainable_networks: Sequence[str] = ("CFE",),
        sequence_class: str = "staggered",
        obs_loss_frames: Sequence[int] | None = None,
        force_reg: float = 1e-2,
        learning_rate: float = 1e-3,
        seed: int = 0,
        skip_nonfinite: bool = True,
        device=None,
    ):
        if sequence_class not in SEQUENCE_CLASSES:
            raise ValueError(f"sequence_class {sequence_class!r} is not ported; "
                             f"choose from {SEQUENCE_CLASSES}")
        if n >= 2 and n & (n - 1) and sequence_class == "staggered":
            raise ValueError(
                f"n must be a power of two for {sequence_class!r}, got {n}")
        self.n = n
        self.pde = pde
        self.sequence_class = sequence_class
        self.trainable_networks = tuple(trainable_networks)
        self.obs_loss_frames = tuple(obs_loss_frames) if obs_loss_frames else (n,)
        bad = [f for f in self.obs_loss_frames if not 1 <= f <= n]
        if bad:
            raise ValueError(
                f"obs_loss_frames must be within 1..n={n}, got {bad}")
        self.force_reg = force_reg
        self.learning_rate = learning_rate
        self.seed = seed
        self.skip_nonfinite = skip_nonfinite
        self.device = torch.device(device) if device is not None \
            else pde.domain.device
        self._prepared = False
        # Which OP levels exist: spans n, n/2, …, 2.
        self.op_spans: list[int] = []
        if sequence_class == "staggered":
            span = n
            while span >= 2:
                self.op_spans.append(span)
                span //= 2

    # ------------------------------------------------------------ lifecycle

    def prepare(self) -> "ControlTraining":
        """Build the networks from a seeded generator and the optimizer."""
        gen = torch.Generator().manual_seed(self.seed)
        nets = {"CFE": self.pde.build_cfe(gen)}
        for span in self.op_spans:
            nets[f"OP{span}"] = self.pde.build_op(gen)
        self.nets = nn.ModuleDict(nets).to(self.device)
        for name in self.trainable_networks:
            if name not in self.nets:
                raise ValueError(f"trainable network {name!r} does not exist; "
                                 f"have {sorted(self.nets)}")
        self.trainable = [p for name in self.trainable_networks
                          for p in self.nets[name].parameters()]
        for name, net in self.nets.items():
            net.requires_grad_(name in self.trainable_networks)
        self.optimizer = torch.optim.Adam(self.trainable, lr=self.learning_rate)
        self.step_count = 0
        self.notfinite_total = 0
        self.notfinite_consec = 0
        self._prepared = True
        return self

    def load_params(self, params: dict[str, dict[str, torch.Tensor]]) -> None:
        """Copy per-network state dicts ({'CFE': {...}, 'OP16': {...}}) in."""
        for name, sd in params.items():
            self.nets[name].load_state_dict(sd)

    def to_batch(self, batch: dict) -> dict[str, torch.Tensor]:
        """numpy arrays or tensors → float32 tensors on the app's device."""
        return {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                for k, v in batch.items()}

    # ----------------------------------------------------------- sequencing

    def _cfe_step(self, state, target_obs):
        x = self.pde.cfe_inputs(state, target_obs)
        force = self.pde.force_from_net(self.nets["CFE"](x), state)
        nxt = self.pde.step(state, force)
        return nxt, {"cost": self.pde.force_cost(force)}

    def _op(self, span, o_a, o_b):
        return self.nets[f"OP{span}"](self.pde.op_inputs(o_a, o_b))

    def rollout(self, batch):
        """Run the configured sequence. Returns (obs_traj (n, B, *s, C),
        aux with per-step 'cost' (n, B), final_state)."""
        gt = _time_major(batch["obs"])[: self.n + 1]  # (n+1, B, *s, C)
        state0 = self.pde.initial_state(batch)
        if self.sequence_class == "chain":
            targets = gt[1:]
        else:
            targets = staggered_targets(self._op, gt[0], gt[-1], self.n)[1:]
        final, obs_traj, aux = run_chain(self._cfe_step, self.pde.observe,
                                         state0, targets)
        return obs_traj, aux, final

    # ---------------------------------------------------------------- losses

    def _loss_fn(self, batch):
        gt = _time_major(batch["obs"])
        obs_traj, aux, _ = self.rollout(batch)
        metrics = {}
        loss = 0.0
        for f in self.obs_loss_frames:
            mse = torch.mean((obs_traj[f - 1] - gt[f]) ** 2)
            metrics[f"obs_mse_f{f}"] = mse
            loss = loss + mse
        force_total = torch.mean(torch.sum(aux["cost"], dim=0))
        metrics["force_cost"] = force_total
        loss = loss + self.force_reg * force_total
        metrics["loss"] = loss
        return loss, metrics

    # ------------------------------------------------------------- training

    def compute_gradients(self, batch) -> dict[str, torch.Tensor]:
        """Forward and backward pass; leaves the gradients on the trainable
        parameters and returns the detached metrics."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self._loss_fn(batch)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def apply_gradients(self) -> bool:
        """One Adam update from the gradients in place, skipped (and
        counted) when any of them is not finite. Returns whether it was
        applied."""
        grads = [p.grad for p in self.trainable if p.grad is not None]
        finite = (not self.skip_nonfinite or not grads or bool(
            torch.stack([torch.isfinite(g).all() for g in grads]).all()))
        if finite:
            self.optimizer.step()
            self.notfinite_consec = 0
        else:
            self.notfinite_total += 1
            self.notfinite_consec += 1
        return finite

    def progress(self, batch) -> dict:
        """One optimization step. Returns the step's metrics (tensors) and
        the not-finite counters."""
        if not self._prepared:
            raise RuntimeError("call prepare() first")
        metrics = self.compute_gradients(self.to_batch(batch))
        self.apply_gradients()
        self.step_count += 1
        if self.skip_nonfinite:
            metrics["notfinite_total"] = self.notfinite_total
            metrics["notfinite_consec"] = self.notfinite_consec
        return metrics

    def evaluate(self, batch) -> dict:
        """The loss terms on `batch`, without gradients, as floats."""
        with torch.no_grad():
            _, metrics = self._loss_fn(self.to_batch(batch))
        return {k: float(v) for k, v in metrics.items()}
