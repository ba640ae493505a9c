"""Execution-sequence builders: the staggered OP tree and the CFE chain.

Counterpart of `pde_control_tpu/control/sequences.py ::
staggered_targets, run_chain`. The chain is a plain Python loop over the
steps, with no activation checkpointing: at the main path's size (64², n=16,
batch 8) eager torch holds every activation in a few hundred MB, and the
backward pass then runs exactly one pressure solve per step.
"""

from __future__ import annotations

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


def run_chain(step_fn: StepFn, observe: Callable, state0, targets):
    """Execute the CFE chain left→right against per-step targets.

    Args:
      step_fn: (state, target) → (next_state, aux dict of tensors).
      observe: state → observation.
      state0: initial state.
      targets: (n, B, *spatial, C) target observation for steps 1..n.
    Returns: (final_state, obs_traj (n, B, *s, C), aux_traj) with every aux
    entry stacked along a leading time axis.
    """
    state = state0
    obs, auxes = [], []
    for tgt in targets:
        state, aux = step_fn(state, tgt)
        obs.append(observe(state))
        auxes.append(aux)
    aux_traj = {key: torch.stack([a[key] for a in auxes]) for key in auxes[0]}
    return state, torch.stack(obs), aux_traj
