"""Adjoint (direct) trajectory optimization — the paper's classical baseline.

Counterpart of `pde_control_tpu/control/adjoint.py :: optimize_forces`:
optimize the per-step forces of ONE batch of trajectories by
backpropagation through the unrolled rollout, with no networks, against
loss = MSE(observe(final), target) + force_reg · mean_B(Σ_t force_cost).
The optimizer is optax's `chain(clip_by_global_norm(grad_clip),
adam(lr))` (`adam(lr)` with `grad_clip=None`), as `control/_adam.py ::
ClippedAdam` over one flat buffer of every force leaf; no schedule and no
non-finite skip, as in the JAX package.

The JAX package runs the whole loop as one device dispatch (`lax.scan`
under `jit`). On the card the port captures one optimizer step (rollout,
backward, clip, Adam) as a CUDA graph, after warm-up steps on a side
stream whose effect is undone, and replays it `iterations` times; the
history is written into device tensors at the replay's index and read
back once at the end. The program (graph, forces, moments, history) is
cached on the PDE per shape and settings, so the equal-shaped
microbatches of `compare_schemes` reuse one graph: the forces, the moments
and the count are reset in place. On the CPU the same step runs in a
Python loop. `remat` is accepted and ignored: eager torch holds the
rollout's activations (ROADMAP "Not ported, by design").
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from pde_control_tpu_torch.control._adam import ClippedAdam
from pde_control_tpu_torch.control.pde_base import PDE, tree_leaves, tree_map
from pde_control_tpu_torch.ops import launch_counts

# Eager steps on a side stream before a capture (as ControlTraining's).
GRAPH_WARMUP_STEPS = 3
HISTORY_KEYS = ("total", "obs_loss", "force_cost")


def _mse(o: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.mean((o - t) ** 2)


class _Program:
    """One optimizer step of a force sequence for one batch shape, its
    state on the device (the flat forces, Adam's moments and count, the
    replay index and the history) and, on the card, its CUDA graph."""

    def __init__(self, pde: PDE, state0, target_obs: torch.Tensor, n: int,
                 iterations: int, learning_rate: float, force_reg: float,
                 obs_loss: Callable, grad_clip: float | None):
        self.pde, self.n, self.force_reg = pde, n, force_reg
        self.obs_loss = obs_loss
        self.template = pde.zero_force(state0)
        leaves = tree_leaves(self.template)
        self.shapes = [(n,) + tuple(leaf.shape) for leaf in leaves]
        self.sizes = [math.prod(s) for s in self.shapes]
        dev = target_obs.device
        self.flat = torch.zeros(sum(self.sizes), device=dev,
                                requires_grad=True)
        self.optimizer = ClippedAdam(self.flat.numel(), dev, learning_rate,
                                     grad_clip)
        self.state0 = tree_map(lambda t: t.detach().clone(), state0)
        self.target = target_obs.detach().clone()
        self.index = torch.zeros(1, dtype=torch.int64, device=dev)
        self.history = torch.zeros((len(HISTORY_KEYS), iterations),
                                   device=dev)
        self.graph = None
        self.launches: dict[str, int] = {}

    def forces(self):
        """The force sequence (leaves (n, B, …)) as views of the flat
        buffer."""
        views = iter(v.view(s) for v, s in zip(self.flat.split(self.sizes),
                                               self.shapes))
        return tree_map(lambda _: next(views), self.template)

    def _state(self) -> list[torch.Tensor]:
        """Every tensor a step updates in place (the forces detached, as
        `ControlTraining._state` keeps them)."""
        opt = self.optimizer
        return [self.flat.detach(), opt.mu, opt.nu, opt.count, self.index,
                self.history]

    def reset(self, state0, target_obs: torch.Tensor) -> None:
        """Load another batch's initial state and target, and zero the
        forces, the moments, the count, the index and the history."""
        for dst, src in zip(tree_leaves(self.state0), tree_leaves(state0)):
            dst.copy_(src)
        self.target.copy_(target_obs)
        for t in self._state():
            t.zero_()

    def step(self) -> None:
        """One optimizer step: rollout, loss, backward, clip, Adam, and the
        history at the current index."""
        pde = self.pde
        self.flat.grad = None
        forces = self.forces()
        state, costs = self.state0, []
        for t in range(self.n):
            force = tree_map(lambda leaf: leaf[t], forces)
            state = pde.step(state, force)
            costs.append(pde.force_cost(force))
        loss = self.obs_loss(pde.observe(state), self.target)
        effort = torch.mean(torch.sum(torch.stack(costs), dim=0))
        total = loss + self.force_reg * effort
        total.backward()
        with torch.no_grad():
            self.flat.add_(self.optimizer.update(self.flat.grad))
            self.history.index_copy_(
                1, self.index, torch.stack([total, loss, effort])[:, None])
            self.index.add_(1)

    def capture(self) -> None:
        """Warm-up steps on a side stream, their effect undone, then the
        capture of one step; `launches` holds one replay's kernel
        launches."""
        dev = self.flat.device
        saved = [t.clone() for t in self._state()]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP_STEPS):
                self.step()
        torch.cuda.current_stream(dev).wait_stream(side)
        for t, s in zip(self._state(), saved):
            t.copy_(s)
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.step()
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}

    def run(self, iterations: int) -> None:
        if self.flat.device.type == "cuda":
            if self.graph is None:
                self.capture()
            for _ in range(iterations):
                self.graph.replay()
        else:
            for _ in range(iterations):
                self.step()


def optimize_forces(
    pde: PDE,
    state0,
    target_obs: torch.Tensor,
    n: int,
    iterations: int = 200,
    learning_rate: float = 0.05,
    force_reg: float = 1e-3,
    obs_loss: Callable | None = None,
    remat: bool = True,
    grad_clip: float | None = 1.0,
):
    """Directly optimize a force sequence to reach `target_obs` at step n.

    Args:
      pde: PDE plugin (provides step/observe/zero_force/force_cost).
      state0: initial full state (batched: a tensor or a dataclass of them).
      target_obs: (B, *spatial, C) observation to reach at step n.
      n: rollout length.
      iterations: optimizer steps (adam).
      force_reg: control-effort regularizer weight.
      obs_loss: optional custom loss(final_obs, target_obs) → scalar;
        defaults to MSE.
      remat: accepted for the JAX package's API and ignored.
      grad_clip: global-norm clip of the gradient; None opts out.
    Returns: (forces with a leading time axis, on the state's device;
      {'total', 'obs_loss', 'force_cost'}: each a (iterations,) float32
      numpy array of the per-iteration history, the value before that
      iteration's update).
    """
    del remat
    if obs_loss is None:
        obs_loss = _mse
    key = (n, iterations, learning_rate, force_reg, obs_loss, grad_clip,
           str(target_obs.device), tuple(target_obs.shape),
           tuple(tuple(leaf.shape) for leaf in tree_leaves(state0)))
    programs = pde.__dict__.setdefault("_adjoint_programs", {})
    program = programs.get(key)
    if program is None:
        program = programs[key] = _Program(
            pde, state0, target_obs, n, iterations, learning_rate, force_reg,
            obs_loss, grad_clip)
    else:
        program.reset(state0, target_obs)
    program.run(iterations)
    with torch.no_grad():
        forces = tree_map(torch.clone, program.forces())
    history = program.history.cpu().numpy()
    return forces, dict(zip(HISTORY_KEYS, history))
