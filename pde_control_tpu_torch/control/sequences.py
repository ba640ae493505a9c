"""Execution-sequence builders: the staggered OP tree, the CFE chain and
prediction refinement.

Counterpart of `pde_control_tpu/control/sequences.py ::
staggered_targets, run_chain, run_refined`. The chain is a plain Python
loop over the steps and the refinement a plain recursion, with no
activation checkpointing: at the main path's size (64², n=16, batch 8)
eager torch holds every activation in a few hundred MB, and the backward
pass then runs exactly one pressure solve per step.

Per-step outputs (aux dicts, and with `keep_states` the states) are
stacked along a leading time axis field by field: tensors, dicts and
dataclasses of tensors (a field that is None stays None).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# step_fn(state, target_obs) -> (next_state, aux) — aux is a dict of
# per-step tensors (e.g. {'cost': (B,)}); run_chain stacks it over time.
StepFn = Callable
# op_fn(span, o_start, o_end) -> o_mid
OpFn = Callable


def staggered_targets(
    op_fn: OpFn, o0: torch.Tensor, on: torch.Tensor, n: int
) -> list[torch.Tensor]:
    """Fill all intermediate observation targets by binary subdivision.

    Returns [o_0, ô_1, …, ô_{n-1}, o_n]: endpoints are the given
    observations; interior frames are OP predictions computed top-down
    (span n, then n/2, … then 2). n must be a power of two. All spans at
    one tree level share one OP network, so a level is one call on the
    level's intervals concatenated along the batch.
    """
    if n & (n - 1):
        raise ValueError(f"n must be a power of two, got {n}")
    obs: dict[int, torch.Tensor] = {0: o0, n: on}
    span = n
    while span >= 2:
        starts = list(range(0, n, span))
        o_a = torch.cat([obs[a] for a in starts], dim=0)
        o_b = torch.cat([obs[a + span] for a in starts], dim=0)
        mids = op_fn(span, o_a, o_b)
        for chunk, a in zip(torch.chunk(mids, len(starts), dim=0), starts):
            obs[a + span // 2] = chunk
        span //= 2
    return [obs[i] for i in range(n + 1)]


def stack_steps(items: list):
    """Stacks a list of per-step outputs (tensors, or dicts or dataclasses
    of them, nested) along a new leading time axis."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, dict):
        return {k: stack_steps([it[k] for it in items]) for k in first}
    return dataclasses.replace(first, **{
        f.name: stack_steps([getattr(it, f.name) for it in items])
        for f in dataclasses.fields(first)})


def run_chain(step_fn: StepFn, observe: Callable, state0, targets,
              keep_states: bool = False):
    """Execute the CFE chain left→right against per-step targets.

    Args:
      step_fn: (state, target) → (next_state, aux dict of tensors).
      observe: state → observation.
      state0: initial state.
      targets: (n, B, *spatial, C) target observation for steps 1..n.
      keep_states: also stack the state after each step (inference).
    Returns: (final_state, obs_traj (n, B, *s, C), aux_traj) with every aux
    entry stacked along a leading time axis, and with keep_states the
    stacked states as a fourth item.
    """
    state = state0
    obs, auxes, states = [], [], []
    for tgt in targets:
        state, aux = step_fn(state, tgt)
        obs.append(observe(state))
        auxes.append(aux)
        if keep_states:
            states.append(state)
    out = (state, torch.stack(obs), stack_steps(auxes))
    return out + (stack_steps(states),) if keep_states else out


def run_refined(step_fn: StepFn, op_fn: OpFn, observe: Callable, state0,
                target: torch.Tensor, n: int, keep_states: bool = False):
    """Prediction-refinement execution (the paper's appendix scheme).

    Recursively: predict the midpoint of [now, now+n] from the *current*
    executed observation, execute the left half against it, then recurse
    on the right half from the actually reached state. Each OP call is its
    own call on the batch (n − 1 of them), since every prediction waits
    for the state the steps before it reached.

    Returns (final_state, obs_traj (n, B, *s, C), aux_traj) and, with
    keep_states, the stacked states as a fourth item. The JAX package's
    `run_refined_scan` computes the same as a `lax.scan` only to bound
    XLA's program size, and its tests pin the two equal; eager torch has
    no program to bound, so this one recursion serves both.
    """
    if n & (n - 1):
        raise ValueError(f"n must be a power of two, got {n}")

    def rec(state, tgt, span):
        if span == 1:
            nxt, aux = step_fn(state, tgt)
            return nxt, [observe(nxt)], [aux], [nxt] if keep_states else []
        o_mid = op_fn(span, observe(state), tgt)
        mid_state, obs_l, aux_l, st_l = rec(state, o_mid, span // 2)
        end_state, obs_r, aux_r, st_r = rec(mid_state, tgt, span // 2)
        return end_state, obs_l + obs_r, aux_l + aux_r, st_l + st_r

    final, obs, auxes, states = rec(state0, target, n)
    out = (final, torch.stack(obs), stack_steps(auxes))
    return out + (stack_steps(states),) if keep_states else out
