"""ControlTraining — the training harness.

Counterpart of `pde_control_tpu/control/training.py :: ControlTraining`
on one device, for every sequence class: 'chain' (supervised next-frame
targets), 'chain_final' (the final target at every step), 'staggered'
(the OP tree's predictions as targets), 'refined' (prediction
refinement) and 'op_supervised' (each OP level trained on ground-truth
triples, no solver). Networks are named 'CFE' and 'OP{span}'; frozen
networks get no update.

The optimizer is the JAX package's
`apply_if_finite(multi_transform({'train': chain(clip_by_global_norm(
grad_clip), adam(lr or cosine_decay_schedule(lr, decay_steps, alpha=0.1))),
'freeze': set_to_zero()}))`, written as tensor code (`control/_adam.py`):
the clip's norm runs over the trainable networks' gradients only, and an
update is skipped, Adam's moments and count included, when any gradient
is not finite, the frozen networks' too (with `skip_nonfinite`, their
gradients of the same loss are computed for that check only). The skip is
a select on the device, and the counters `notfinite_total` and
`notfinite_consec` are device tensors: a step reads nothing back.

`progress_multi` runs K steps for one call. On the card it replays one
captured CUDA graph of the whole step (forward, backward, update) K
times; on the CPU it runs the same step K times.

Not ported yet: the dataset, `train()`, checkpoints and restore, the
logger, the mesh (queue A5/A6 of ROADMAP.md), and the `remat` and
`scan_unroll` knobs, which eager torch does not need.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from pde_control_tpu_torch.control._adam import ClippedAdam
from pde_control_tpu_torch.control.pde_base import PDE
from pde_control_tpu_torch.control.sequences import (
    run_chain,
    run_refined,
    stack_steps,
    staggered_targets,
)
from pde_control_tpu_torch.ops import launch_counts

SEQUENCE_CLASSES = ("chain", "chain_final", "staggered", "refined",
                    "op_supervised")
# Eager steps on a side stream before a capture: the first use of every
# kernel, plan, table and cuDNN handle happens there, never in the capture.
GRAPH_WARMUP_STEPS = 3


def _time_major(obs: torch.Tensor) -> torch.Tensor:
    """(B, T, *s, C) → (T, B, *s, C)."""
    return torch.movedim(obs, 1, 0)


@dataclasses.dataclass
class _StepGraph:
    """One captured training step: its static input and output tensors and
    the kernel launches that one replay runs."""
    graph: "torch.cuda.CUDAGraph"
    inputs: dict[str, torch.Tensor]
    metrics: dict[str, torch.Tensor]
    launches: dict[str, int]


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
        grad_clip: float | None = None,
        lr_schedule: str | None = None,  # None | 'cosine'
        decay_steps: int | None = None,  # the cosine's horizon in updates
        skip_nonfinite: bool = True,
        divergence_abort: int = 200,
        refined_impl: str = "auto",  # accepted for the JAX package's API;
        # every value runs `sequences.run_refined` (see there)
        device=None,
    ):
        if sequence_class not in SEQUENCE_CLASSES:
            raise ValueError(f"unknown sequence_class {sequence_class!r}")
        if (n >= 2 and n & (n - 1)
                and sequence_class in ("staggered", "refined",
                                       "op_supervised")):
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
        self.grad_clip = grad_clip
        self.lr_schedule = lr_schedule
        if lr_schedule == "cosine" and not decay_steps:
            raise ValueError(
                "lr_schedule='cosine' needs decay_steps (the stage's planned "
                "iteration count) — a fixed horizon silently disables decay "
                "for typical 300-2000-iter stages")
        self.decay_steps = decay_steps
        self.skip_nonfinite = skip_nonfinite
        self.divergence_abort = divergence_abort
        if refined_impl not in ("auto", "scan", "unrolled"):
            raise ValueError(f"unknown refined_impl {refined_impl!r}")
        self.refined_impl = ("scan" if n >= 32 else "unrolled") \
            if refined_impl == "auto" else refined_impl
        self.seed = seed
        self.device = torch.device(device) if device is not None \
            else pde.domain.device
        self._prepared = False
        # Which OP levels exist: spans n, n/2, …, 2.
        self.op_spans: list[int] = []
        if sequence_class in ("staggered", "refined", "op_supervised"):
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
        self.frozen = [p for name, net in self.nets.items()
                       if name not in self.trainable_networks
                       for p in net.parameters()] if self.skip_nonfinite else []
        for name, net in self.nets.items():
            net.requires_grad_(name in self.trainable_networks
                               or self.skip_nonfinite)
        self.optimizer = ClippedAdam(
            sum(p.numel() for p in self.trainable), self.device,
            self.learning_rate, self.grad_clip,
            self.decay_steps if self.lr_schedule == "cosine" else None)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        self.notfinite_total, self.notfinite_consec = zero, zero.clone()
        self.step_count = 0
        self._graphs: dict[tuple, _StepGraph] = {}
        self.graph_launches: dict[str, int] = {}
        self._prepared = True
        return self

    def load_params(self, params: dict[str, dict[str, torch.Tensor]]) -> None:
        """Copy per-network state dicts ({'CFE': {...}, 'OP16': {...}}) in.
        Drops the captured steps."""
        for name, sd in params.items():
            self.nets[name].load_state_dict(sd)
        self._graphs.clear()

    def to_batch(self, batch: dict) -> dict[str, torch.Tensor]:
        """numpy arrays or tensors → float32 tensors on the app's device."""
        return {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                for k, v in batch.items()}

    def moments(self) -> dict[str, dict[str, tuple[torch.Tensor, torch.Tensor]]]:
        """Adam's (first, second) moments per trainable network and
        parameter name, as views of the optimizer's flat buffers."""
        out, start = {}, 0
        for name in self.trainable_networks:
            for key, p in self.nets[name].named_parameters():
                end = start + p.numel()
                out.setdefault(name, {})[key] = (
                    self.optimizer.mu[start:end].view_as(p),
                    self.optimizer.nu[start:end].view_as(p))
                start = end
        return out

    # ----------------------------------------------------------- sequencing

    def _cfe_step(self, state, target_obs, keep_force: bool = False):
        x = self.pde.cfe_inputs(state, target_obs)
        force = self.pde.force_from_net(self.nets["CFE"](x), state)
        nxt = self.pde.step(state, force)
        cost = self.pde.force_cost(force)
        return nxt, ({"cost": cost, "force": force} if keep_force
                     else {"cost": cost})

    def _op(self, span, o_a, o_b):
        return self.nets[f"OP{span}"](self.pde.op_inputs(o_a, o_b))

    def rollout(self, batch, keep_states: bool = False,
                keep_forces: bool = False):
        """Run the configured sequence. Returns (obs_traj (n, B, *s, C),
        aux, final_state[, states]): aux holds the per-step 'cost' (n, B)
        and, with keep_forces, 'force', the control forces with a leading
        time axis; states, with keep_states, the state after each step."""
        gt = _time_major(batch["obs"])[: self.n + 1]  # (n+1, B, *s, C)
        state0 = self.pde.initial_state(batch)

        def step_fn(s, t):
            return self._cfe_step(s, t, keep_force=keep_forces)

        observe = self.pde.observe
        if self.sequence_class == "refined":
            out = run_refined(step_fn, self._op, observe, state0, gt[-1],
                              self.n, keep_states=keep_states)
        else:
            if self.sequence_class == "chain":
                targets = gt[1:]
            elif self.sequence_class == "chain_final":
                targets = gt[-1][None].expand((self.n,) + gt[-1].shape)
            elif self.sequence_class == "staggered":
                targets = staggered_targets(self._op, gt[0], gt[-1],
                                            self.n)[1:]
            else:
                raise ValueError(self.sequence_class)
            out = run_chain(step_fn, observe, state0, targets,
                            keep_states=keep_states)
        final, obs_traj, aux = out[:3]
        return (obs_traj, aux, final) + out[3:]

    # ---------------------------------------------------------------- losses

    def _op_supervised_loss(self, batch):
        """Per-level OP pretraining on aligned ground-truth triples: the
        trainable OP levels, or every level when none is trainable."""
        gt = _time_major(batch["obs"])
        loss = 0.0
        metrics = {}
        trained = [s for s in self.op_spans
                   if f"OP{s}" in self.trainable_networks]
        for span in trained or self.op_spans:
            starts = range(0, self.n - span + 1, span)
            lvl = 0.0
            for a in starts:
                pred = self._op(span, gt[a], gt[a + span])
                lvl = lvl + torch.mean((pred - gt[a + span // 2]) ** 2)
            lvl = lvl / max(len(starts), 1)
            metrics[f"op{span}_mse"] = lvl
            loss = loss + lvl
        metrics["loss"] = loss  # evaluate()'s contract: every class has it
        return loss, metrics

    def _loss_fn(self, batch):
        if self.sequence_class == "op_supervised":
            return self._op_supervised_loss(batch)
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
        parameters (and, with `skip_nonfinite`, on the frozen ones for the
        finiteness check) and returns the detached metrics. The previous
        gradients are dropped first, so that the backward pass allocates
        them anew (inside a capture, from the graph's pool)."""
        for p in self.trainable + self.frozen:
            p.grad = None
        loss, metrics = self._loss_fn(batch)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def apply_gradients(self) -> torch.Tensor:
        """One clipped Adam update of the trainable parameters from the
        gradients in place (a parameter without one takes zeros), skipped
        and counted when any gradient, the frozen networks' included, is
        not finite. Drops the frozen networks' gradients. Returns whether
        it was applied, as a 0-d bool tensor on the device: nothing is read
        back."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.trainable]
        flat = (torch.cat([g.reshape(-1) for g in grads]) if grads
                else torch.zeros(0, device=self.device))
        applied = None
        if self.skip_nonfinite:
            checked = [flat] + [p.grad.reshape(-1) for p in self.frozen
                                if p.grad is not None]
            applied = torch.isfinite(torch.cat(checked)).all()
            self.notfinite_total.add_((~applied).int())
            self.notfinite_consec.copy_(torch.where(
                applied, 0, self.notfinite_consec + 1))
        for p in self.frozen:
            p.grad = None
        step = self.optimizer.update(flat, applied)
        if self.trainable:
            with torch.no_grad():
                torch._foreach_add_(self.trainable, [
                    s.view_as(p) for s, p in zip(
                        step.split([p.numel() for p in self.trainable]),
                        self.trainable)])
        return torch.ones((), dtype=torch.bool, device=self.device) \
            if applied is None else applied

    def _step(self, batch: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """One optimization step on a batch of device tensors; returns its
        metrics and, with `skip_nonfinite`, the counters after it."""
        metrics = self.compute_gradients(batch)
        self.apply_gradients()
        if self.skip_nonfinite:
            metrics["notfinite_total"] = self.notfinite_total.clone()
            metrics["notfinite_consec"] = self.notfinite_consec.clone()
        return metrics

    def progress(self, batch) -> dict:
        """One optimization step. Returns the step's metrics and the
        not-finite counters, as device tensors."""
        if not self._prepared:
            raise RuntimeError("call prepare() first")
        metrics = self._step(self.to_batch(batch))
        self.step_count += 1
        return metrics

    def progress_multi(self, batches) -> dict:
        """K optimization steps. `batches`: a batch dict with a leading
        (K, B, …) axis. Returns the K steps' metrics stacked on a leading K
        axis, and advances `step_count` by K.

        On the CPU it runs the step of `progress` K times. On the card it
        replays one CUDA graph of the whole step (forward, backward,
        update) K times: batch k is copied into the graph's static inputs
        before replay k and its metrics out of the static outputs after
        it. The graph is captured at the first call for a batch shape and
        kept until `load_params`; a capture that fails raises (there is
        no eager fallback). `graph_launches` holds the kernel launches
        one replay runs (the wrappers count a captured launch once, at
        capture, and a replay not at all)."""
        if not self._prepared:
            raise RuntimeError("call prepare() first")
        batches = self.to_batch(batches)
        k = next(iter(batches.values())).shape[0]
        if self.device.type != "cuda":
            out = stack_steps([self._step({key: v[i] for key, v in
                                           batches.items()})
                               for i in range(k)])
        else:
            graph = self._step_graph(batches)
            out = {name: torch.empty((k,) + t.shape, dtype=t.dtype,
                                     device=t.device)
                   for name, t in graph.metrics.items()}
            for i in range(k):
                for key, buf in graph.inputs.items():
                    buf.copy_(batches[key][i])
                graph.graph.replay()
                for name, t in graph.metrics.items():
                    out[name][i].copy_(t)
            self.graph_launches = graph.launches
        self.step_count += k
        return out

    def _state(self) -> list[torch.Tensor]:
        """Every tensor a step updates in place, the parameters detached (a
        clone of a parameter itself would keep its gradient accumulator,
        and so the stream it was made on, alive into a capture)."""
        opt = self.optimizer
        return [*(p.detach() for p in self.trainable), opt.mu, opt.nu,
                opt.count, self.notfinite_total, self.notfinite_consec]

    def _step_graph(self, batches: dict[str, torch.Tensor]) -> _StepGraph:
        """The captured step for this batch shape, captured on first use
        after warm-up steps whose effect on the state is undone."""
        key = tuple((name, tuple(v.shape[1:])) for name, v in
                    sorted(batches.items()))
        if key in self._graphs:
            return self._graphs[key]
        inputs = {name: v[0].clone() for name, v in batches.items()}
        saved = [t.clone() for t in self._state()]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP_STEPS):
                self._step(inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        for t, s in zip(self._state(), saved):
            t.copy_(s)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            metrics = self._step(inputs)
        after = launch_counts()
        self._graphs[key] = _StepGraph(graph, inputs, metrics, {
            name: after[name] - before[name] for name in after})
        return self._graphs[key]

    def _check_divergence(self, last: dict) -> None:
        """Abort the stage once a long streak of consecutive updates was
        non-finite (and so skipped): the parameters are stuck at their last
        finite value and the forward pass gives NaN from there on. Reads
        `last['notfinite_consec']` (a number, as a log point holds it)."""
        if (self.divergence_abort
                and last.get("notfinite_consec", 0) >= self.divergence_abort):
            raise RuntimeError(
                f"stage diverged: {int(last['notfinite_consec'])} consecutive "
                f"non-finite-gradient steps (total skipped "
                f"{int(last.get('notfinite_total', 0))}) at step "
                f"{self.step_count}. Params remain at the last finite value. "
                "Typical causes: force_reg too small (forces blow past the "
                "CFL clip), lr too high, or non-finite training data.")

    def evaluate(self, batch) -> dict:
        """The loss terms on `batch`, without gradients, as floats."""
        with torch.no_grad():
            _, metrics = self._loss_fn(self.to_batch(batch))
        return {k: float(v) for k, v in metrics.items()}

    def infer_all_frames(self, batch, keep_states: bool = False,
                         keep_forces: bool = False):
        """Full-sequence inference without gradients. Returns (obs_traj,
        force costs (n, B), final_state[, states][, forces]): `forces` is
        the control force of each step, with a leading time axis."""
        with torch.no_grad():
            obs_traj, aux, final, *states = self.rollout(
                self.to_batch(batch), keep_states=keep_states,
                keep_forces=keep_forces)
        return tuple([obs_traj, aux["cost"], final, *states]
                     + ([aux["force"]] if keep_forces else []))
