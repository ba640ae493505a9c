"""Sweep of the kernels' plans on one NVIDIA GPU: are `cuda_conv.dw_plan`
(K5), `cuda_conv.fwd_plan` (K4), `cuda_fluid.bwd_plan` (K3) and
`cuda_cg.solve_plan` (K1) near the best?

    python3 sweep_dw_plan.py          # K5, then K4
    python3 sweep_dw_plan.py fwd      # K4 only
    python3 sweep_dw_plan.py bwd      # K3 only
    python3 sweep_dw_plan.py cg       # K1 and K2 only

For each conv shape below (the 64², n=16, batch-8 training iteration's
shape families) it times K5 (`conv3x3_dw_bf16`, both passes) under every
plan its launcher takes (`cuda_conv.dw_plans`: rows per run in {1, 2,
4, ..} and about 1, 2, 4, .. splits, fitting the card's shared memory),
and K4 (`conv3x3_fwd_bf16`, forward and dX, both passes) under every plan
of `cuda_conv.fwd_plans` (each output-channel tile and fragments per warp
by each count of splits of K); and K3 (`fused_step_bwd_f32`, the fused step's backward) under
every cluster size its launcher takes (512 threads a block) at 64²×8 and
64²×64 (the main path's step, tol 1e-4 / maxiter 100, and maxiter 0: the
rest without the CG trips), and K1 (`pcg_solve_f32`, cold and warm) and
K2 (`fused_step_fwd_f32`) the same way. It prints the time under the plan's choice,
cuDNN's time for the same function (none for K3) and the five fastest
plans, or for K3 every plan with its time per trip and, at the plan's
choice, the SM cycles of each phase of a CG trip (`fused_bwd_trace`).
Device times by CUDA-graph replay (`chip_smoke._graph_ms`), beside the
card's name and power limit.
It checks nothing: `chip_smoke.py` and `tests/test_torch_kernels.py` hold
the kernels to their plain versions.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke
from pde_control_tpu_torch.ops import cuda_conv, cuda_fluid

# (batch, H, W, Cin, Cout)
SHAPES = [(8, 64, 64, 64, 64), (8, 64, 64, 32, 64), (8, 64, 64, 64, 32),
          (8, 64, 64, 5, 32), (8, 64, 64, 32, 1), (64, 64, 64, 3, 16),
          (64, 64, 64, 16, 16), (64, 64, 64, 32, 16), (64, 32, 32, 32, 32),
          (64, 32, 32, 64, 32), (64, 16, 16, 64, 64), (16, 16, 16, 128, 64),
          (8, 8, 8, 128, 128), (64, 8, 8, 128, 128)]


def sweep_fwd(card: str, rng) -> None:
    dev = torch.device("cuda")
    for shape in SHAPES:
        b, h, w, cin, cout = shape
        x, g = (torch.tensor(rng.normal(size=(b, h, w, c)), dtype=torch.float32,
                             device=dev).to(torch.bfloat16) for c in (cin, cout))
        wflat = torch.tensor(rng.normal(size=(9 * cin, cout)) / np.sqrt(9 * cin),
                             dtype=torch.float32, device=dev).to(torch.bfloat16)
        bias = torch.zeros(cout, dtype=torch.bfloat16, device=dev)
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        w_oihw = wflat.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous()
        for d, inp, k_in, k_out, rotated, plan_call, library in (
                ("fwd", x, cin, cout, False,
                 lambda: cuda_conv.conv3x3_forward(x, wflat, bias),
                 lambda: F.conv2d(xn, w_oihw, bias, padding=1)),
                ("dX", g, cout, cin, True, lambda: cuda_conv.conv3x3_dx(g, wflat),
                 lambda: torch.nn.grad.conv2d_input(xn.shape, w_oihw, gn,
                                                    padding=1))):
            plan = cuda_conv.fwd_plan(b, h, w, k_in, k_out)
            plan_ms = chip_smoke._graph_ms(plan_call, 20)
            library_ms = chip_smoke._graph_ms(library, 20)
            swept = {}
            for p in cuda_conv.fwd_plans(b, h, w, k_in, k_out):
                swept[p.bn, p.fm, p.splits] = chip_smoke._graph_ms(
                    lambda p=p: cuda_conv._fwd_launch(
                        d, inp, wflat, None if rotated else bias, k_in, k_out,
                        rotated, p), 20)
            ranked = sorted((ms, key) for key, ms in swept.items())
            print(f"K4 {d} {b}x{h}x{w} {k_in}->{k_out}: fwd_plan bn {plan.bn} x "
                  f"fm {plan.fm} x seg {plan.seg} x splits {plan.splits} "
                  f"{plan_ms:.4f} ms, cuDNN {library_ms:.4f} ms; fastest swept: "
                  + "; ".join(f"{ms:.4f} ms bn {bn} x fm {fm} x splits {s}"
                              for ms, (bn, fm, s) in ranked[:5])
                  + f" [{card}]", flush=True)
            print("  all swept (ms bn fm splits): " + ", ".join(
                f"{ms:.4f} {bn} {fm} {s}" for ms, (bn, fm, s) in ranked))


def sweep_bwd(card: str, rng) -> None:
    """K3 under every plan at 64²×8 and ×64: the time per launch, the time
    at maxiter 0 (everything but the CG trips) and so the time per trip."""
    from pde_control_tpu_torch.grids import Domain2D

    dev = torch.device("cuda")
    h = chip_smoke.H
    domain = Domain2D.create(h, h, obstacle_mask=chip_smoke._plate(h), device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    kw = dict(chip_smoke.FUSED_STEP, dx=domain.dx, tol=1e-4)
    for batch in (chip_smoke.BATCH, 64):
        ops, cots = chip_smoke._fused_operands(rng, h, h, "cold", domain, dev,
                                               batch=batch)
        state = (ops.pop("vy"), ops.pop("vx"), ops.pop("rho"))
        plan = cuda_fluid.bwd_plan(batch, h, h, kw["max_shift"])
        swept = []
        for p in cuda_fluid.bwd_plans(h, h):
            def call(p=p, maxiter=100):
                return cuda_fluid._launch_backward(*state, *cots, *geom, p,
                                                   has_force=True,
                                                   has_inflow=False,
                                                   maxiter=maxiter, **kw)
            trips = float(call()[-1].float().mean())
            ms, rest = (chip_smoke._graph_ms(call, 20),
                        chip_smoke._graph_ms(lambda: call(maxiter=0), 20))
            swept.append((ms, rest, 1e3 * (ms - rest) / trips, p))
        plan_ms = next(ms for ms, _, _, p in swept if p == plan)
        print(f"K3 {h}x{h}x{batch}: bwd_plan {chip_smoke._plan_text(plan)} "
              f"{plan_ms:.4f} ms; swept (ms, ms at maxiter 0, us per trip, "
              "cluster, threads): " + ", ".join(
                  f"{ms:.4f} {rest:.4f} {us:.2f} {p.cluster} {p.threads}"
                  for ms, rest, us, p in sorted(swept, key=lambda x: x[0]))
              + f" [{card}]", flush=True)
        _trip_profile(lambda: cuda_fluid._launch_backward(
            *state, *cots, *geom, plan, has_force=True, has_inflow=False,
            maxiter=100, **kw), f"{h}x{h}x{batch}", card)


# The phases of `TripClock` in csrc/pcg_cluster.cuh.
TRIP_PHASES = ("A d, d.Ad sum, push of A d", "residual update", "Qy r",
               "(.) Qx^T * 1/lam", "push of the spectrum", "Qy^T (.)",
               "(.) Qx", "r.z, r.r sum, projection, d update")


def _trip_profile(launch, label: str, card: str) -> None:
    """SM clock cycles per CG trip of each phase, as the first block of one
    K3 launch (rank 0 of sample 0) records them with the profile on."""
    import ctypes

    from pde_control_tpu_torch.ops import _build

    trace = _build.load()[0].fused_bwd_trace
    trace.argtypes, trace.restype = [ctypes.c_void_p], ctypes.c_int
    clocks = torch.zeros(len(TRIP_PHASES), dtype=torch.int64, device="cuda")
    if trace(clocks.data_ptr()) != 0:
        raise RuntimeError("fused_bwd_trace failed")
    try:
        trips = int(launch()[-1][0])
        torch.cuda.synchronize()
    finally:
        trace(None)
    cycles = [c / trips for c in clocks.tolist()]
    total = sum(cycles)
    print(f"K3 {label} trip profile (rank 0 of sample 0, {trips} trips, "
          f"{total:.0f} SM cycles a trip): " + "; ".join(
              f"{name} {c:.0f} ({100 * c / total:.1f}%)"
              for name, c in zip(TRIP_PHASES, cycles)) + f" [{card}]",
          flush=True)


def sweep_cg(card: str, rng) -> None:
    """K1 (cold, and warm from the plain solution with 5% noise) and K2 (on
    chip_smoke's warm operands) under every plan at 64²×8 and ×64: the time
    per launch, the time at maxiter 0 (no trip) and so the time per
    trip."""
    from pde_control_tpu_torch.grids import Domain2D
    from pde_control_tpu_torch.ops import cuda_cg

    dev = torch.device("cuda")
    h = chip_smoke.H
    domain = Domain2D.create(h, h, obstacle_mask=chip_smoke._plate(h), device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    for batch in (chip_smoke.BATCH, 64):
        div = torch.tensor(rng.normal(size=(batch, h, h)), dtype=torch.float32,
                           device=dev)
        p = cuda_cg.pcg_plain(div, *geom, tol=1e-6, maxiter=500)[0]
        noise = torch.tensor(rng.normal(size=(batch, h, h)), dtype=torch.float32,
                             device=dev)
        plan = cuda_cg.solve_plan(batch, h, h)
        for start, x0 in (("cold", None),
                          ("warm", (p + 0.05 * p.std() * noise).contiguous())):
            swept = []
            for pl in cuda_cg.solve_plans(h, h):
                def call(pl=pl, x0=x0, maxiter=100):
                    return cuda_cg._launch_solve(div, *geom, x0, pl, dx=1.0,
                                                 closed=True, tol=1e-4,
                                                 maxiter=maxiter, precond=True)
                trips = float(call()[-1].float().mean())
                ms, rest = (chip_smoke._graph_ms(call, 20),
                            chip_smoke._graph_ms(lambda: call(maxiter=0), 20))
                swept.append((ms, rest, 1e3 * (ms - rest) / trips, pl))
            plan_ms = next(ms for ms, _, _, pl in swept if pl == plan)
            _print_swept(f"K1 {start} {h}x{h}x{batch}: solve_plan", plan,
                         plan_ms, swept, card)
        ops, _ = chip_smoke._fused_operands(rng, h, h, "warm", domain, dev,
                                            batch=batch)
        state = (ops.pop("vy"), ops.pop("vx"), ops.pop("rho"))
        step_ops = [ops.get(k) for k in ("fy", "fx", "inflow", "x0")]
        kw = dict(chip_smoke.FUSED_STEP, dx=domain.dx, tol=1e-4)
        plan = cuda_fluid.fwd_plan(batch, h, h)
        swept = []
        for pl in cuda_fluid.fwd_plans(h, h):
            def call(pl=pl, maxiter=100):
                return cuda_fluid._launch_forward(*state, *geom, *step_ops, pl,
                                                  maxiter=maxiter, **kw)
            trips = float(call()[-1].float().mean())
            ms, rest = (chip_smoke._graph_ms(call, 20),
                        chip_smoke._graph_ms(lambda: call(maxiter=0), 20))
            swept.append((ms, rest, 1e3 * (ms - rest) / trips, pl))
        plan_ms = next(ms for ms, _, _, pl in swept if pl == plan)
        _print_swept(f"K2 {h}x{h}x{batch}: fwd_plan", plan, plan_ms, swept, card)


def _print_swept(label: str, plan, plan_ms: float, swept: list, card: str):
    print(f"{label} {chip_smoke._plan_text(plan)} {plan_ms:.4f} ms; swept (ms, "
          "ms at maxiter 0, us per trip, cluster): " + ", ".join(
              f"{ms:.4f} {rest:.4f} {us:.2f} {pl.cluster}"
              for ms, rest, us, pl in sorted(swept, key=lambda x: x[0]))
          + f" [{card}]", flush=True)


def main() -> None:
    card = chip_smoke.device_phase()
    rng = np.random.default_rng(chip_smoke.SEED)
    if sys.argv[1:] == ["bwd"]:
        sweep_bwd(card, rng)
        return
    if sys.argv[1:] == ["cg"]:
        sweep_cg(card, rng)
        return
    if sys.argv[1:] != ["fwd"]:
        sweep_dw(card, rng)
    sweep_fwd(card, rng)


def sweep_dw(card: str, rng) -> None:
    dev = torch.device("cuda")
    for shape in SHAPES:
        b, h, w, cin, cout = shape
        x, g = (torch.tensor(rng.normal(size=(b, h, w, c)), dtype=torch.float32,
                             device=dev).to(torch.bfloat16) for c in (cin, cout))
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        library_ms = chip_smoke._graph_ms(
            lambda: torch.nn.grad.conv2d_weight(xn, (cout, cin, 3, 3), gn,
                                                padding=1), 20)
        plan = cuda_conv.dw_plan(*shape)
        plan_ms = chip_smoke._graph_ms(lambda: cuda_conv.conv3x3_dw(x, g), 20)
        best = sorted((chip_smoke._graph_ms(
            lambda p=p: cuda_conv._dw_launch(x, g, p), 20), p.rows,
            p.runs_per_block, p.splits, p.shared_bytes)
            for p in cuda_conv.dw_plans(*shape))[:5]
        print(f"{b}x{h}x{w} {cin}->{cout}: dw_plan rows {plan.rows} x runs "
              f"{plan.runs_per_block} x splits {plan.splits} {plan_ms:.4f} ms, "
              f"cuDNN {library_ms:.4f} ms; fastest swept: " + "; ".join(
                  f"{ms:.4f} ms rows {rows} x runs {rpb} x splits {splits} "
                  f"({shared} B shared)" for ms, rows, rpb, splits, shared in best)
              + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()
