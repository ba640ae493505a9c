"""Per-phase breakdown of the benchmark training iteration: where does the
time of the 64² n=16 batch-8 staggered training step go?

Counterpart of `pde_control_tpu/experiments/profile_bench.py`, on the
app of `__graft_entry__._make_app(64, 16, 8, maxiter=100)` (the plate, the
buoyancy control, CFE 32-64-64-32, U-nets base 16 / 3 levels, bf16 nets).
Phases:
  * the whole train step: eager (`progress`), and as one `progress_multi`
    call of K = 8 steps (CUDA-graph replays on the card; eager steps on the
    CPU, which has no graph);
  * the forward loss (no gradients);
  * the physics rollout (16 × fluid_step, zero force), forward and
    forward + backward (the gradient of the final density's sum with
    respect to the initial density);
  * one step's forward, its advection alone and its projection alone;
  * the OP target tree (`staggered_targets`);
  * the CFE chain with the physics, and the 16 CFE applications alone;
  * the optimizer update (zero gradients).
Each phase is timed after two warm-up calls in `blocks` blocks of `inner`
calls: by CUDA events on the card, by the host clock on the CPU, and each
line says which. A line gives the median ms per call and the blocks'
spread (min–max). Then the FLOP count of one training step: the nets'
convolutions and matmuls, forward and backward, from
`torch.utils.flop_counter.FlopCounterMode`, plus the advection windows of
the 16 steps (forward and adjoint; the pressure solve's trips are not
counted), as `mfu`, a share of the H100's dense bf16 peak over the eager
and the graph step's time; on the CPU the mfu is not measured.

Usage:
    python -m pde_control_tpu_torch.experiments.profile_bench [--json] \
        [--device cuda|cpu] [--size 64]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

H, N, B = 64, 16, 8
K_MULTI = 8
# One H100 SXM at its full power limit, dense bf16 on the tensor cores
# (NVIDIA's data sheet): the nets' compute type.
PEAK_BF16_FLOPS = 989e12


def make_app(h: int, n: int, batch_size: int, device, maxiter: int = 100,
             fused: str = "auto", conv_impl: str = "xla",
             backend: str = "auto", sequence_class: str = "staggered",
             **train):
    """The port's counterpart of `__graft_entry__._make_app`, with the
    pressure solve's `backend`; `sequence_class` and `train` (grad_clip,
    lr_schedule, …) go to `ControlTraining`. Every net the class builds is
    trainable: the CFE and the OP nets, or under 'chain' and 'chain_final'
    the CFE alone."""
    from pde_control_tpu_torch import (
        ControlTraining,
        Domain2D,
        FluidConfig,
        IncompressibleFluidPDE,
    )
    from pde_control_tpu_torch.experiments.curriculum import op_spans

    obstacle = np.zeros((h, h), np.float32)
    obstacle[h // 2, h // 4:h // 2] = 1.0
    domain = Domain2D.create(h, h, obstacle_mask=obstacle, device=device)
    cfg = FluidConfig(dt=1.0, buoyancy=0.08, pressure_tol=1e-4,
                      pressure_maxiter=maxiter, warm_start_pressure=True,
                      pressure_backend=backend, fused=fused)
    pde = IncompressibleFluidPDE(
        domain, cfg, control="buoyancy", unet_levels=2 if h <= 16 else 3,
        conv_impl=conv_impl, cfe_features=(32, 64, 64, 32),
        op_base_features=16)
    # The chain classes build the CFE alone (the curriculum's CFE stage).
    ops = () if sequence_class.startswith("chain") else tuple(
        f"OP{s}" for s in op_spans(n))
    return ControlTraining(
        n, pde, batch_size=batch_size, trainable_networks=("CFE",) + ops,
        sequence_class=sequence_class, obs_loss_frames=(n,), **train).prepare()


def make_batch(h: int, n: int, batch_size: int, seed: int = 0) -> dict:
    """`__graft_entry__._make_batch`."""
    rng = np.random.default_rng(seed)
    return {"obs": rng.uniform(0, 1, size=(batch_size, n + 1, h, h, 1)
                               ).astype(np.float32),
            "vy0": np.zeros((batch_size, h + 1, h), np.float32),
            "vx0": np.zeros((batch_size, h, h + 1), np.float32)}


class Timer:
    """Times a callable after a warm-up: CUDA events on the card, the host
    clock elsewhere. Returns the median ms per call over the blocks and
    the blocks' min and max."""

    def __init__(self, device: torch.device, blocks: int = 5, inner: int = 4):
        self.cuda = device.type == "cuda"
        self.clock = "CUDA events" if self.cuda else "host clock"
        self.blocks, self.inner = blocks, inner

    def __call__(self, fn, per_call: int = 1) -> dict:
        for _ in range(2):
            fn()
        times = []
        for _ in range(self.blocks):
            if self.cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                torch.cuda.synchronize()
                start.record()
                for _ in range(self.inner):
                    fn()
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
            else:
                t0 = time.perf_counter()
                for _ in range(self.inner):
                    fn()
                ms = 1e3 * (time.perf_counter() - t0)
            times.append(ms / (self.inner * per_call))
        return {"ms": statistics.median(times), "min": min(times),
                "max": max(times), "clock": self.clock}


def _window_flops(b: int, h: int, w: int, steps: int) -> float:
    """The advection windows' operations (rho, vy, vx) over `steps` steps,
    forward and adjoint, counted per output cell from the taps that carry
    weight, as `chip_smoke._window_flops` counts them (22 forward, 52
    adjoint)."""
    cells = b * (h * w + (h + 1) * w + h * (w + 1))
    return float(steps * cells * (22 + 52))


def step_flops(app, batch) -> dict:
    """FLOPs of one training step: the nets' (convs and matmuls, forward
    and backward, by FlopCounterMode) and the advection windows'."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        app.compute_gradients(app.to_batch(batch))
    h, w = app.pde.domain.grid_shape
    return {"nets": float(counter.get_total_flops()),
            "stencils": _window_flops(app.batch_size, h, w, app.n)}


def run(device="cuda", h: int = H, n: int = N, b: int = B,
        blocks: int = 5, inner: int = 4) -> dict:
    """Times every phase (module docstring); returns {phase: timing} with
    the FLOP count and the mfu."""
    from pde_control_tpu_torch.control.sequences import staggered_targets
    from pde_control_tpu_torch.physics.advect import (
        advect_centered,
        advect_staggered,
    )
    from pde_control_tpu_torch.physics.fluid import divergence_free

    device = torch.device(device)
    app = make_app(h, n, b, device)
    batch = make_batch(h, n, b)
    tb = app.to_batch(batch)
    pde = app.pde
    timer = Timer(device, blocks, inner)
    with torch.no_grad():
        state0 = pde.initial_state(tb)
        obs0 = pde.observe(state0)
    multi = app.to_batch({k: np.stack([v] * K_MULTI) for k, v in batch.items()})
    res: dict[str, dict] = {}

    res["train_step_full"] = timer(lambda: app.progress(batch))
    res["train_step_full"]["how"] = "eager progress()"
    res["train_step_graph"] = timer(lambda: app.progress_multi(multi),
                                    per_call=K_MULTI)
    res["train_step_graph"]["how"] = (
        f"progress_multi, {K_MULTI} CUDA-graph replays a call"
        if device.type == "cuda" else
        f"progress_multi, {K_MULTI} eager steps a call (no graph on the CPU)")

    def no_grad(fn):
        def run_():
            with torch.no_grad():
                fn()
        return run_

    res["forward_loss"] = timer(no_grad(lambda: app._loss_fn(tb)))

    def physics_rollout(state):
        for _ in range(n):
            state = pde.step(state, None)
        return state.density

    res["physics_rollout_fwd"] = timer(no_grad(lambda: physics_rollout(state0)))

    def rollout_fwd_bwd():
        d0 = state0.density.clone().requires_grad_(True)
        s = type(state0)(velocity=state0.velocity, density=d0,
                         inflow=state0.inflow, pressure=state0.pressure)
        torch.autograd.grad(physics_rollout(s).sum(), d0)

    res["physics_rollout_fwd_bwd"] = timer(rollout_fwd_bwd)
    res["fluid_step_fwd"] = timer(no_grad(lambda: pde.step(state0, None)))
    cfg, dx = pde.cfg, pde.domain.dx
    adv = dict(dx=dx, mode=cfg.advection_mode, max_shift=cfg.max_shift)
    res["advection_only_fwd"] = timer(no_grad(lambda: (
        advect_staggered(state0.velocity, cfg.dt, **adv),
        advect_centered(state0.density, state0.velocity, cfg.dt, **adv))))
    res["projection_only_fwd"] = timer(no_grad(
        lambda: divergence_free(state0.velocity, pde.domain, cfg)))
    res["op_tree_fwd"] = timer(no_grad(
        lambda: staggered_targets(app._op, obs0, obs0, n)))

    def cfe_chain():
        s = state0
        for _ in range(n):
            s, _aux = app._cfe_step(s, obs0)

    res["cfe_chain_with_physics_fwd"] = timer(no_grad(cfe_chain))
    x = pde.cfe_inputs(state0, obs0)
    cfe = app.nets["CFE"]
    res["cfe_nets_only_fwd_x16"] = timer(no_grad(
        lambda: sum(cfe(x).sum() for _ in range(n))))

    def optimizer_update():
        for p in app.trainable:
            p.grad = None
        app.apply_gradients()

    res["optimizer_update"] = timer(optimizer_update)

    flops = step_flops(app, batch)
    total = flops["nets"] + flops["stencils"]
    for key in ("train_step_full", "train_step_graph"):
        t = res[key]
        t["steps_per_sec"] = n * b / (t["ms"] / 1e3)
        t["mfu"] = (total / (t["ms"] / 1e3) / PEAK_BF16_FLOPS
                    if device.type == "cuda" else None)
    res["flops_per_step"] = dict(flops, total=total)
    return res


def _card() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def lines(res: dict, where: str) -> list[str]:
    """The printed report: one line a phase, then the FLOP count."""
    out = []
    width = max(len(k) for k in res)
    for key, t in res.items():
        if key == "flops_per_step":
            continue
        text = (f"{key:<{width}}  {t['ms']:10.3f} ms  (min {t['min']:.3f}, "
                f"max {t['max']:.3f}; {t['clock']}")
        if "how" in t:
            text += f"; {t['how']}"
        text += ")"
        if "steps_per_sec" in t:
            mfu = ("not measured (not on the card)" if t["mfu"] is None
                   else f"{100 * t['mfu']:.3f}% of the H100's dense bf16 peak")
            text += f"  steps/s {t['steps_per_sec']:.1f}, mfu {mfu}"
        out.append(f"{text} [{where}]")
    f = res["flops_per_step"]
    out.append(f"{'flops_per_step':<{width}}  nets {f['nets']:.4e} "
               f"(convs and matmuls, forward and backward), advection "
               f"windows {f['stencils']:.4e}, total {f['total']:.4e} "
               f"(pressure solve not counted)")
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--json", action="store_true",
                   help="print one JSON object instead of the lines")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--size", type=int, default=H, help="grid side")
    args = p.parse_args(argv)
    res = run(args.device, h=args.size)
    where = _card() if args.device.startswith("cuda") else "cpu, host clock"
    if args.json:
        print(json.dumps({"device": where, **res}))
    else:
        print("\n".join(lines(res, where)))


if __name__ == "__main__":
    main()
