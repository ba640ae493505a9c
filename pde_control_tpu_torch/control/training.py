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
times; on the CPU it runs the same step K times. `train()` drives it from
the dataset, drawing batches with `np.random.default_rng(seed + 1)` (and
validation batches with `seed + 7919`) exactly as the JAX package draws
them, and reads metrics back only at its log points.

Stages compose through per-network checkpoints that the JAX package reads
and writes too (`utils/checkpoint.py`): `restore=` in `prepare()`,
`save(names=…)`, and the full resume state of `save_state` /
`restore_state` / `autosave`.

`mesh=` (`parallel/mesh.py :: make_mesh`) trains data-parallel: one
process per device, each holding a replica of the networks and the
optimizer state (broadcast from rank 0 after `prepare`, `restore_state`
and `load_params`). Every rank draws the same global batch from the same
stream and keeps its slice, so the batch sequence is the `mesh=None`
run's. After the backward pass the trainable gradient is all-reduced and
divided by the world size (every loss term is a mean over the batch, so
the mean of equal shards' gradients is the global batch's), the
not-finite flag is all-reduced with MAX (the frozen networks' gradients
stay local), and the metrics are all-reduced to their global means. Only
rank 0 writes checkpoints, autosaves and logs; the ranks meet at a
barrier after each write. On the card `progress_multi` captures the step
with its NCCL all-reduce; a gloo group cannot be captured, and
`progress_multi` on CUDA tensors under one raises. `infer_all_frames`
runs the whole batch on each rank. The `remat` and `scan_unroll` knobs
are not ported: eager torch does not need them.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from pde_control_tpu_torch.control._adam import ClippedAdam
from pde_control_tpu_torch.control.pde_base import PDE
from pde_control_tpu_torch.control.sequences import (
    run_chain,
    run_refined,
    stack_steps,
    staggered_targets,
)
from pde_control_tpu_torch.data.scene import DeviceDataset
from pde_control_tpu_torch.ops import launch_counts
from pde_control_tpu_torch.parallel.mesh import (
    all_reduce_mean,
    barrier,
    is_writer,
    replicate,
    shard_batch,
    shard_batch_multi,
)
from pde_control_tpu_torch.utils.checkpoint import (
    load_network,
    load_training_state,
    restore_networks,
    save_networks,
    save_training_state,
)
from pde_control_tpu_torch.utils.convert import _flax_tree, _state_dict
from pde_control_tpu_torch.utils.logging import MetricsLogger
from pde_control_tpu_torch.utils.viz import save_comparison_png, tb_image

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
    """One captured training step: its static input and output tensors, the
    kernel launches that one replay runs, and the host seconds its capture
    and its instantiation took. The graph keeps its cudaGraph_t
    (`graph.raw_cuda_graph()`), so that its nodes can be counted."""
    graph: "torch.cuda.CUDAGraph"
    inputs: dict[str, torch.Tensor]
    metrics: dict[str, torch.Tensor]
    launches: dict[str, int]
    capture_s: float
    instantiate_s: float


class ControlTraining:
    def __init__(
        self,
        n: int,
        pde: PDE,
        dataset=None,
        val_dataset=None,
        batch_size: int = 16,
        trainable_networks: Sequence[str] = ("CFE",),
        sequence_class: str = "staggered",
        obs_loss_frames: Sequence[int] | None = None,
        force_reg: float = 1e-2,
        learning_rate: float = 1e-3,
        restore: dict[str, str] | str | None = None,  # a checkpoint dir, or
        # {network: dir or .msgpack file}; applied in prepare()
        seed: int = 0,
        logdir: str | None = None,
        mesh=None,  # parallel.mesh.Mesh: data-parallel over its ranks
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
        if mesh is not None and batch_size % mesh.size != 0:
            raise ValueError(
                f"batch_size={batch_size} must be divisible by the mesh size "
                f"({mesh.size} devices) for data-parallel sharding")
        self.mesh = mesh
        self.n = n
        self.pde = pde
        self.dataset = dataset
        self.val_dataset = val_dataset
        self.batch_size = batch_size
        self.restore = restore
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
            else pde.device
        self.logger = MetricsLogger(logdir if is_writer(mesh) else None)
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
        """Build the networks from a seeded generator, restore checkpoints
        (`restore`), build the optimizer and the sampling streams, and put
        the datasets on the device (`DeviceDataset.wrap`)."""
        if self.dataset is not None:
            self.dataset = DeviceDataset.wrap(self.dataset, self.device)
        if self.val_dataset is not None:
            self.val_dataset = DeviceDataset.wrap(self.val_dataset,
                                                  self.device)
        gen = torch.Generator().manual_seed(self.seed)
        nets = {"CFE": self.pde.build_cfe(gen)}
        for span in self.op_spans:
            nets[f"OP{span}"] = self.pde.build_op(gen)
        self.nets = nn.ModuleDict(nets).to(self.device)
        self._restore_checkpoints()
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
        self._np_rng = np.random.default_rng(self.seed + 1)
        # A separate stream for validation draws: evaluate() must not
        # consume training draws, or val_every would change the training
        # batch sequence.
        self._val_rng = np.random.default_rng(self.seed + 7919)
        self._prepared = True
        self._replicate()
        return self

    def _replicate(self) -> None:
        """Under a mesh, broadcast the networks, the optimizer state and
        the counters from rank 0."""
        if self.mesh is None:
            return
        opt = self.optimizer
        replicate([*self.nets.state_dict().values(), opt.mu, opt.nu,
                   opt.count, self.notfinite_total, self.notfinite_consec],
                  self.mesh)

    def _restore_checkpoints(self) -> None:
        """Load `restore` into the networks: a directory restores every
        network it holds; a dict names a directory or file per network."""
        if not self.restore:
            return
        current = {name: net.state_dict() for name, net in self.nets.items()}
        if isinstance(self.restore, str):
            restored = restore_networks(self.restore, current)
        else:
            restored = {}
            for name, path in self.restore.items():
                if os.path.isdir(path):
                    path = os.path.join(path, f"{name}.msgpack")
                restored[name] = load_network(path, current[name])
        for name, sd in restored.items():
            if sd is not current[name]:
                self.nets[name].load_state_dict(sd)

    def close(self) -> None:
        """Drop the captured step graphs, returning their memory pools to
        the device, and close the logger. The app can still evaluate and
        save; training again captures anew."""
        self._graphs.clear()
        self.logger.close()
        self.logger = MetricsLogger(None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def load_params(self, params: dict[str, dict[str, torch.Tensor]]) -> None:
        """Copy per-network state dicts ({'CFE': {...}, 'OP16': {...}}) in.
        Drops the captured steps."""
        for name, sd in params.items():
            self.nets[name].load_state_dict(sd)
        self._graphs.clear()
        self._replicate()

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
        if self.mesh is not None:
            all_reduce_mean(flat, self.mesh)
            if applied is not None:
                # Every rank must take or skip the update: a frozen
                # network's gradient is local, so the flag is reduced.
                bad = (~applied).int()
                dist.all_reduce(bad, op=dist.ReduceOp.MAX)
                applied = bad == 0
        if applied is not None:
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
        metrics = self._global_metrics(metrics)
        if self.skip_nonfinite:
            metrics["notfinite_total"] = self.notfinite_total.clone()
            metrics["notfinite_consec"] = self.notfinite_consec.clone()
        return metrics

    def _global_metrics(self, metrics: dict) -> dict:
        """Under a mesh, each metric's mean over the ranks (one
        all-reduce); without one, the metrics as they are."""
        if self.mesh is None:
            return metrics
        names = list(metrics)
        flat = all_reduce_mean(torch.stack([metrics[k].float()
                                            for k in names]), self.mesh)
        return dict(zip(names, flat.unbind()))

    def _device_batch(self, batch: dict) -> dict[str, torch.Tensor]:
        """A global batch → this rank's slice of it on the device."""
        if self.mesh is not None:
            batch = shard_batch(batch, self.mesh)
        return self.to_batch(batch)

    def progress(self, batch=None) -> dict:
        """One optimization step, on `batch` or a batch sampled from the
        dataset (under a mesh, the global batch: each rank takes its
        slice). Returns the step's metrics and the not-finite counters,
        as device tensors."""
        if not self._prepared:
            raise RuntimeError("call prepare() first")
        if batch is None:
            batch = self.dataset.sample(self._np_rng, self.batch_size)
        metrics = self._step(self._device_batch(batch))
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
        if self.mesh is not None:
            if self.device.type == "cuda" and self.mesh.backend != "nccl":
                raise RuntimeError(
                    f"progress_multi captures the step in a CUDA graph, and a "
                    f"{self.mesh.backend} group's collectives cannot be "
                    "captured: use an NCCL mesh, or progress() for eager steps")
            batches = shard_batch_multi(batches, self.mesh)
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

    def sample_batches(self, k: int) -> dict:
        """k sampled batches stacked along a new leading axis (for
        progress_multi)."""
        if hasattr(self.dataset, "sample_stacked"):
            return self.dataset.sample_stacked(self._np_rng, k,
                                               self.batch_size)
        samples = [self.dataset.sample(self._np_rng, self.batch_size)
                   for _ in range(k)]
        return {key: np.stack([s[key] for s in samples]) for key in samples[0]}

    def _prefetch(self) -> dict[str, torch.Tensor]:
        """Sample the next (global) batch and put it on the device."""
        return self.to_batch(self.dataset.sample(self._np_rng,
                                                 self.batch_size))

    def train(self, iterations: int, log_every: int = 50,
              val_every: int | None = None, render: bool = True,
              steps_per_call: int = 1, autosave_dir: str | None = None,
              autosave_every: int = 500,
              autosave_restore: bool = False) -> dict:
        """Run the stage; returns the last logged metrics (floats).

        steps_per_call > 1 runs that many steps per `progress_multi` call
        (one CUDA graph replayed per step on the card); `iterations` is
        then rounded up to a multiple of steps_per_call, and the result's
        `iterations_run` says how many ran. Metrics are read back only at
        log points (every `log_every` steps and the last), where the
        divergence check runs.

        autosave_dir enables mid-stage crash recovery: every
        `autosave_every` steps the full training state is saved; with
        autosave_restore, an existing autosave is restored first and only
        `iterations - restored_step` steps run (`iterations` stays the
        stage's total). The sampling stream's position is not part of the
        state, so a resumed stage sees another batch order.

        With a logdir and `render`, each log point renders the rollout's
        final frame beside its target (PNG under the logdir, and a
        TensorBoard image)."""
        restored = 0
        if autosave_dir and autosave_restore:
            restored = self.try_restore_autosave(autosave_dir)
            if restored >= iterations:
                return {"resumed_mid_stage": restored,
                        "iterations_run": restored}
        if steps_per_call > 1:
            return self._train_fused(iterations - restored, log_every,
                                     val_every, render, steps_per_call,
                                     autosave_dir, autosave_every, restored)
        last = {}
        t0 = time.time()
        iterations = iterations - restored
        next_autosave = autosave_every
        nxt = self._prefetch()
        for i in range(iterations):
            cur = nxt
            if i + 1 < iterations:
                nxt = self._prefetch()
            metrics = self.progress(cur)
            if (i + 1) % log_every == 0 or i == iterations - 1:
                last = {k: float(v) for k, v in metrics.items()}
                last["steps_per_sec"] = (i + 1) / (time.time() - t0)
                self.logger.log(self.step_count, last, prefix="train/")
                self._check_divergence(last)
                if render:
                    self._render_progress(cur)
            if val_every and (i + 1) % val_every == 0 and self.val_dataset:
                self.logger.log(self.step_count, self.evaluate(),
                                prefix="val/")
            if autosave_dir and i + 1 >= next_autosave:
                next_autosave += autosave_every
                self.autosave(autosave_dir)
        if restored:
            last["resumed_mid_stage"] = restored
            last["iterations_run"] = restored + iterations
        return last

    def _train_fused(self, iterations: int, log_every: int,
                     val_every: int | None, render: bool, k: int,
                     autosave_dir: str | None = None,
                     autosave_every: int = 500, restored: int = 0) -> dict:
        """The loop of `train` at k steps a `progress_multi` call."""
        requested = iterations
        if iterations % k:
            # A whole number of k-step calls: a shorter tail would capture
            # a second graph.
            iterations = (iterations // k + 1) * k
        last = {}
        t0 = time.time()
        done = 0
        next_autosave = autosave_every
        nxt = self.to_batch(self.sample_batches(k))
        next_log = log_every
        next_val = val_every or 0
        while done < iterations:
            cur = nxt
            k_cur = int(next(iter(cur.values())).shape[0])
            k_next = min(k, iterations - done - k_cur)
            if k_next > 0:
                nxt = self.to_batch(self.sample_batches(k_next))
            metrics = self.progress_multi(cur)
            done += k_cur
            if done >= next_log or done >= iterations:
                while next_log <= done:
                    next_log += log_every
                last = {key: float(v[-1]) for key, v in metrics.items()}
                last["steps_per_sec"] = done / (time.time() - t0)
                self.logger.log(self.step_count, last, prefix="train/")
                self._check_divergence(last)
                if render:
                    self._render_progress({key: v[-1]
                                           for key, v in cur.items()})
            if val_every and done >= next_val and self.val_dataset:
                while next_val <= done:
                    next_val += val_every
                self.logger.log(self.step_count, self.evaluate(),
                                prefix="val/")
            if autosave_dir and done >= next_autosave:
                while next_autosave <= done:
                    next_autosave += autosave_every
                self.autosave(autosave_dir)
        last["iterations_run"] = restored + iterations
        if restored:
            last["resumed_mid_stage"] = restored
        if iterations != requested:
            self.logger.log(self.step_count,
                            {"iterations_requested": requested,
                             "iterations_run": iterations}, prefix="train/")
        return last

    def _render_progress(self, batch) -> None:
        """Render the rollout's final frame beside its target to the
        logdir (and TensorBoard)."""
        if not self.logger.logdir or self.sequence_class == "op_supervised":
            return
        obs_traj = self.infer_all_frames(batch)[0]
        pred = obs_traj[self.n - 1][0, ..., 0].cpu().numpy()
        tgt = torch.as_tensor(batch["obs"])[0, self.n, ..., 0].cpu().numpy()
        save_comparison_png(
            {"rollout final": pred, "target": tgt},
            os.path.join(self.logger.logdir,
                         f"fields_{self.step_count:06d}.png"))
        if pred.ndim == 2:
            tb_image(self.logger, "rollout_final", pred, self.step_count)
            tb_image(self.logger, "target", tgt, self.step_count)

    # ---------------------------------------------------------- checkpoints

    def state_dicts(self) -> dict[str, dict[str, torch.Tensor]]:
        """Every network's state dict, by name."""
        return {name: net.state_dict() for name, net in self.nets.items()}

    def _opt_state(self) -> dict:
        """The optimizer's state as the JAX package's optax state tree
        serializes it (`flax.serialization.to_state_dict` of
        `apply_if_finite(multi_transform({'train': chain(clip, adam(lr or
        schedule)), 'freeze': set_to_zero()}))`'s state, built at
        `pde_control_tpu/control/training.py:211-228`): Adam's moments of
        every trainable network under its flax names (kernels HWIO), {} for
        a frozen one (optax's MaskedNode), Adam's count, which also stands
        for the schedule's (they advance together under apply_if_finite),
        and the non-finite counters. Arrays on the CPU."""
        count = self.optimizer.count.cpu().numpy()
        moments = self.moments()
        mu, nu = ({name: _flax_tree({k: m[i] for k, m in moments[name].items()})
                   if name in moments else {} for name in self.nets}
                  for i in (0, 1))
        train = {"0": {"count": count, "mu": mu, "nu": nu},
                 "1": {"count": count} if self.optimizer.decay_steps else {}}
        if self.grad_clip:
            train = {"0": {}, "1": train}
        tree = {"inner_states": {"freeze": {"inner_state": {}},
                                 "train": {"inner_state": train}}}
        if not self.skip_nonfinite:
            return tree
        consec = self.notfinite_consec.cpu().numpy()
        return {"inner_state": tree, "last_finite": consec == 0,
                "notfinite_count": consec,
                "total_notfinite": self.notfinite_total.cpu().numpy()}

    def _load_opt_state(self, tree: dict) -> None:
        """Copy an `_opt_state` tree (of tensors, structure checked) into
        the optimizer's buffers and the counters."""
        if self.skip_nonfinite:
            self.notfinite_consec.copy_(tree["notfinite_count"])
            self.notfinite_total.copy_(tree["total_notfinite"])
            tree = tree["inner_state"]
        train = tree["inner_states"]["train"]["inner_state"]
        if self.grad_clip:
            train = train["1"]
        adam = train["0"]
        if self.optimizer.decay_steps and not torch.equal(
                train["1"]["count"], adam["count"]):
            raise ValueError("optimizer state: the schedule's count "
                             f"{int(train['1']['count'])} is not Adam's "
                             f"{int(adam['count'])}")
        self.optimizer.count.copy_(adam["count"])
        for name, params in self.moments().items():
            for i, key in ((0, "mu"), (1, "nu")):
                sd = _state_dict(adam[key][name])
                for k, pair in params.items():
                    pair[i].copy_(sd[k])

    def save_state(self, directory: str) -> None:
        """Full resume checkpoint: networks, optimizer state (optax's tree,
        `_opt_state`), step counter; the JAX package resumes it too."""
        opt_state = self._opt_state()
        if is_writer(self.mesh):
            save_training_state(directory, self.state_dicts(), opt_state,
                                self.step_count,
                                {"sequence_class": self.sequence_class})
        barrier(self.mesh)

    def restore_state(self, directory: str) -> None:
        """Resume from either package's save_state (same configuration and
        trainable set; another raises ValueError). Everything is copied in
        place; the captured graphs are dropped."""
        params, opt_state, self.step_count = load_training_state(
            directory, self.state_dicts(), self._opt_state())
        for name, sd in params.items():
            self.nets[name].load_state_dict(sd)
        self._load_opt_state(opt_state)
        self._graphs.clear()
        self._replicate()

    def autosave(self, directory: str) -> None:
        """Crash-safe periodic save_state: write to a sibling tmp dir, move
        the previous autosave aside, swap the tmp in, then drop the old one.
        A kill at any point leaves the old or the new state restorable
        (state.json is written last; try_restore_autosave falls back to the
        .old dir if the swap itself was interrupted)."""
        tmp, old = directory + ".tmp", directory + ".old"
        if is_writer(self.mesh):
            shutil.rmtree(tmp, ignore_errors=True)
            shutil.rmtree(old, ignore_errors=True)
        self.save_state(tmp)
        if is_writer(self.mesh):
            if os.path.isdir(directory):
                os.replace(directory, old)
            os.replace(tmp, directory)
            shutil.rmtree(old, ignore_errors=True)
        barrier(self.mesh)

    def try_restore_autosave(self, directory: str) -> int:
        """Restore a mid-stage autosave if one exists (or its `.old` copy);
        returns the restored step count (0 = nothing restored)."""
        for src in (directory, directory + ".old"):
            if os.path.exists(os.path.join(src, "state.json")):
                self.restore_state(src)
                return self.step_count
        return 0

    def save(self, directory: str, names: Sequence[str] | None = None) -> None:
        """Write per-network msgpacks. `names` restricts which networks are
        written: a supervised stage saving into a shared directory passes
        its trained net only, or the later spans would be written at
        random init and a resumed run would take them for finished."""
        params = self.state_dicts()
        if names is not None:
            missing = [n for n in names if n not in params]
            if missing:
                raise ValueError(f"save(names=...): unknown nets {missing}")
            params = {k: v for k, v in params.items() if k in names}
        if is_writer(self.mesh):
            save_networks(directory, params, {
                "n": self.n,
                "sequence_class": self.sequence_class,
                "trainable": list(self.trainable_networks),
                "steps": self.step_count,
            })
        barrier(self.mesh)

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
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            metrics = self._step(inputs)
        t1 = time.perf_counter()
        graph.instantiate()
        after = launch_counts()
        self._graphs[key] = _StepGraph(graph, inputs, metrics, {
            name: after[name] - before[name] for name in after}, t1 - t0,
            time.perf_counter() - t1)
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

    def evaluate(self, batch=None) -> dict:
        """The loss terms on `batch`, or on a batch drawn from the
        validation set with the validation stream, without gradients, as
        floats (under a mesh, each rank's slice, then the global means)."""
        if batch is None:
            batch = self.val_dataset.sample(self._val_rng, self.batch_size)
        with torch.no_grad():
            _, metrics = self._loss_fn(self._device_batch(batch))
        return {k: float(v) for k, v in self._global_metrics(metrics).items()}

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
