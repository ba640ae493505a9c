"""Profiling and numeric-debug hooks.

Counterpart of `pde_control_tpu/utils/profiling.py`:
  * `trace(logdir)` — a `torch.profiler` context (CPU, and CUDA where there
    is a card) that writes a Chrome trace (`trace.json`) into `logdir`
    when it exits; chrome://tracing and Perfetto read it.
  * `named(...)` — `torch.profiler.record_function`, a named range in the
    trace.
  * `enable_nan_checks()` — autograd's anomaly detection. It differs from
    the JAX package's `jax_debug_nans`, which checks every primitive's
    output: anomaly detection checks the backward only, raising where a
    backward function returns NaN and naming the forward operation that
    made it. A NaN produced in a forward pass without gradients passes.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile

named = torch.profiler.record_function


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; write `logdir/trace.json` when it exits."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def enable_nan_checks(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)
