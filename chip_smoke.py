"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):
  1. device: needs CUDA; prints the card, its power limit and the TF32
     settings (both off);
  2. build: compiles the CUDA kernels from `pde_control_tpu_torch/csrc`
     (one nvcc per source, in parallel), prints each kernel's registers and
     spills (a kernel the report does not know, a K3, K4 or K5 kernel
     missing from it or one that spills fails), checks the kernels'
     shared-memory counts against the Python gates and plans, and prints
     K3's plan at 64²×8 and ×64;
  3. the pressure solve (K1) against its plain torch version on the card:
     64² (bench plate, closed), 32² (open, with an obstacle), 48² and 96²
     (closed), batch 8, warm and cold, at tol 1e-4 / 100 iterations and
     tol 1e-6 / 500, under `solve_plan`'s plan and every plan its launcher
     takes; residuals, solution error, trip counts, the gradient through
     `solve_pressure` against the plain path; against the JAX package's
     goldens (`tests/goldens/pcg_32.npz`); times at 64²×8 and ×64, tol
     1e-4 / 100, and the plans;
  4. the fused step's forward (K2) and backward (K3) against their plain
     versions: 64², 32², 32×48, 24×30 and 8×8, closed with the plate,
     batch 8, cold and warm, with force, with inflow, at zero velocity (the
     tie points), and with a NaN and an infinity planted in the velocity
     (the non-finite cells must be the plain version's), at tol 1e-6 / 500,
     each under its plan (`fwd_plan`, `bwd_plan`) and under every plan its
     launcher takes, each twice for the same bits; both against the JAX
     package's goldens (`tests/goldens/fused_step_32.npz`); then their
     times at 64²×8, tol 1e-4 / 100, at maxiter 0 (the rest without the CG
     trips) and at batch 64, and their plans;
  5. the first iteration of each training path below, every one with the
     same perturbed CFE output layer, so that every net has a gradient; the
     conv path's run records the shape of every conv its kernels compute;
  6. the main path, unfused: the 64² smoke-control training iteration
     (n=16, batch 8, full widths, bf16 nets) with the pressure solve on K1;
     the first iteration against the plain solve, 2 warm-up and 5 timed
     iterations, K1's launches;
  7. the main path, fused (`FluidConfig.fused='cuda'`): the same
     iteration with each step on K2 and K3; the first iteration against
     the unfused one, 2 warm-up and 5 timed iterations, K2's and K3's
     launches;
  8. the main path, fused, with the nets' 3×3 stride-1 convs on K4/K5
     (`conv_impl='cuda'`): the first iteration against the fused cuDNN
     path, 2 warm-up and 5 timed iterations, the launches of all five
     kernels;
  9. the rest of the training step, on the 'refined' class (every net
     trainable, grad clip 1.0, cosine over 100 updates): its first
     iteration on the conv path against K1 with cuDNN; one op_supervised
     step on the conv path; `progress_multi` (K = 8 replays of one CUDA
     graph of the step) against 8 `progress` calls from the same state;
     both timed on the three paths (CUDA events and the host clock over
     the K steps, steps/s, peak memory, launches a step: counted by the
     wrappers for eager steps, the captured step's times K for replays);
     a NaN batch inside a replay, skipped;
 10. the 3×3 conv's forward and dX (K4) and dW (K5) against the JAX
     package's goldens (`tests/goldens/conv3x3_32.npz`) under every plan
     their launchers take, and against their plain
     versions at every conv shape the conv path ran, with db, then their
     device times (CUDA-graph replay) beside the plain versions', cuDNN's
     and the bound, per launch and summed over one iteration; K5's bound
     also with the bytes of its fp32 partials; y, dX and dW the same bits
     in two calls; each shape's K4 and K5 plans. Then K4 alone at the
     shapes its tiles, segments and splits could get wrong, checked but not
     timed, and K5 alone at the shapes its runs of whole rows could get
     wrong, checked and timed; neither is summed. It runs last because the
     graphs' memory pools would raise the paths' peak memory.
The line before the last is the kernels' JSON summary; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import subprocess
import time

import numpy as np
import torch

H, N, BATCH = 64, 16, 8
SEED = 0
CFE_FEATURES, UNET_LEVELS = (32, 64, 64, 32), 3
SPANS = [N >> i for i in range(N.bit_length() - 1)]  # the OP nets: 16, 8, 4, 2
# One H100 SXM at its full power limit: fp32 outside the tensor cores, bf16
# dense on the tensor cores, and HBM (NVIDIA's data sheet). K1-K3 are fp32
# CUDA-core work, K4/K5 bf16 tensor-core work.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# K5's first-pass instantiations <channel fragments, Cout fragments> and its
# second pass: each must stand in ptxas's report, without spills (K4's are
# listed by `cuda_conv.FWD_TILES` in the build phase).
K5_KERNELS = {f"conv3x3_dw_kernel<{cf}, {nf}>" for cf in (1, 2)
              for nf in (1, 2, 4)} | {"conv3x3_dw_reduce_kernel"}
# K3's instantiations <threads, trip profile>: the main path's and the one
# `fused_bwd_trace` selects; and K1's and K2's (512 threads). Each must
# stand in ptxas's report, without spills.
K3_KERNELS = {"fused_bwd_kernel<512, 0>", "fused_bwd_kernel<512, 1>"}
K1_K2_KERNELS = {"pcg_cluster_kernel<512>", "fused_fwd_kernel<512>"}
# (batch, H, W, Cin, Cout) that the main path does not reach and K4's plan
# could get wrong: positions the tiles do not divide, one row, one column,
# an image cut into segments of columns (W = 700 and 4096), Cin 3 and 5
# (and 1 for dX), Cout 1, partial channel slices and Cout tiles, and
# shapes where the plan splits K.
K4_EDGE_SHAPES = [(3, 7, 9, 16, 24), (2, 1, 64, 32, 32), (4, 16, 1, 16, 16),
                  (1, 1, 1, 5, 1), (2, 9, 700, 16, 64), (1, 3, 4096, 16, 16),
                  (8, 12, 12, 3, 32), (4, 10, 10, 5, 32), (6, 11, 13, 32, 1),
                  (3, 5, 6, 40, 72), (2, 4, 4, 128, 64), (40, 5, 8, 128, 128)]
# (batch, H, W, Cin, Cout) that the main path does not reach and K5's plan
# of whole rows could get wrong: rows the runs do not divide, one row, one
# column, W below a fragment's 16 pixels, one output channel under four
# channel tiles, blocks whose runs pass from one sample to the next.
K5_EDGE_SHAPES = [(3, 7, 9, 16, 24), (2, 13, 64, 32, 32), (40, 13, 64, 32, 32),
                  (4, 1, 16, 32, 16), (4, 16, 1, 16, 16), (8, 8, 8, 64, 128),
                  (2, 16, 16, 128, 1), (5, 3, 64, 64, 64), (40, 5, 8, 128, 128)]


def _phase(name: str) -> None:
    print(f"== {name}", flush=True)


def device_phase() -> str:
    _phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
          f"count {torch.cuda.device_count()}")
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(smi)
    return smi.splitlines()[0]


def build_phase() -> None:
    _phase("build")
    from pde_control_tpu_torch.ops import _build, cuda_cg, cuda_conv, cuda_fluid

    lib, info = _build.load()
    k4_kernels = {f"conv3x3_fwd_kernel<{bn}, {fm}, {rot}>"
                  for bn, fm in cuda_conv.FWD_TILES
                  for rot in (0, 1)} | {"conv3x3_fwd_reduce_kernel"}
    print(info.log.strip())
    print(f"build_seconds {info.seconds:.2f} ({info.path.name})")
    seen = {}
    for block in info.log.split("Compiling entry function")[1:]:
        name = re.search(r"((?:pcg_cluster|fused_fwd|fused_bwd|conv3x3_fwd_reduce|"
                         r"conv3x3_fwd|conv3x3_dw_reduce|conv3x3_dw)_kernel)"
                         r"(?:I((?:L[a-z]+\d+E)+)E)?", block)
        regs = re.search(r"Used (\d+) registers", block)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           block)
        smem = re.search(r"(\d+) bytes smem", block)
        if not (name and regs and spills):
            raise AssertionError("ptxas reports a kernel this script does not "
                                 f"know: {block.splitlines()[0]}")
        args = re.findall(r"L[a-z]+(\d+)E", name.group(2) or "")
        label = name.group(1) + (f"<{', '.join(args)}>" if args else "")
        seen[label] = int(spills.group(1)) + int(spills.group(2))
        print(f"ptxas {label}: {regs.group(1)} registers, "
              f"{spills.group(1)} bytes spill stores, {spills.group(2)} "
              f"bytes spill loads"
              + (f", {smem.group(1)} bytes static shared memory" if smem
                 else ""))
        # Device functions the kernel calls and does not inline (K3's
        # solve) report spills of their own; printed, not held.
        for callee, stores, loads in re.findall(
                r"Function properties for \S*?([a-z]{3}_solve)I\S*\n\s+\d+ bytes "
                r"stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                block):
            print(f"  called by {label}, not inlined: {callee}: {stores} bytes "
                  f"spill stores, {loads} bytes spill loads")
    checked = k4_kernels | K5_KERNELS | K3_KERNELS | K1_K2_KERNELS
    if checked - set(seen):
        raise AssertionError(f"no ptxas report for {sorted(checked - set(seen))}")
    if any(seen[k] for k in checked):
        raise AssertionError(f"a kernel spills: "
                             f"{ {k: seen[k] for k in checked if seen[k]} }")
    shapes = ((H, H), (32, 32), (48, 48), (96, 96), (32, 48), (24, 30), (8, 8))
    for name, c_name, plans, plan, query in (
            ("K1", "pcg_shared_bytes", cuda_cg.solve_plans, cuda_cg.solve_plan,
             cuda_cg._kernel()[1]),
            ("K2", "fused_fwd_shared_bytes", cuda_fluid.fwd_plans,
             cuda_fluid.fwd_plan, cuda_fluid._kernels()[3])):
        fn = getattr(lib, c_name)
        fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_size_t
        cases = [(h, w, p) for h, w in shapes for p in plans(h, w)]
        for h, w, p in cases:
            if fn(h, w, p.cluster, p.threads) != p.shared_bytes:
                raise AssertionError(f"{c_name}({h}, {w}, {p.cluster}, "
                                     f"{p.threads}): kernel asks "
                                     f"{fn(h, w, p.cluster, p.threads)} bytes, "
                                     f"the plan counts {p.shared_bytes}")
        print(f"{c_name} equal to the plan's count at {len(cases)} cases")
        for batch in (BATCH, 64):
            print(f"{name} plan at {H}x{H}x{batch}: "
                  f"{_plan_text(plan(batch, H, H))}")
        print(f"{name} clusters resident at once at {H}x{H} "
              "(cudaOccupancyMaxActiveClusters): " + ", ".join(
                  f"C={p.cluster}: {query(H, H, p.cluster, p.threads)}"
                  for p in plans(H, H)))
    fn = lib.fused_bwd_shared_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_size_t
    bwd_cases = [(h, w, c, cuda_fluid.BWD_THREADS)
                 for h, w in ((H, H), (32, 32), (32, 48), (8, 8), (84, 84))
                 for c in cuda_fluid.BWD_CLUSTERS if c <= h]
    for h, w, c, t in bwd_cases:
        want = cuda_fluid.bwd_shared_bytes(h, w, c, t, FUSED_STEP["max_shift"])
        if fn(h, w, c, t, FUSED_STEP["max_shift"]) != want:
            raise AssertionError(f"fused_bwd_shared_bytes({h}, {w}, {c}, {t}): "
                                 f"kernel asks {fn(h, w, c, t, 2)} bytes, the "
                                 f"plan counts {want}")
    for batch in (BATCH, 64):
        plan = cuda_fluid.bwd_plan(batch, H, H, FUSED_STEP["max_shift"])
        if fn(H, H, plan.cluster, plan.threads, 2) != plan.shared_bytes:
            raise AssertionError(f"bwd_plan {plan}: the kernel asks "
                                 f"{fn(H, H, plan.cluster, plan.threads, 2)} bytes")
        print(f"K3 plan at {H}x{H}x{batch}: {_plan_text(plan)}")
    print(f"fused_bwd_shared_bytes equal to the plan's count at "
          f"{len(bwd_cases)} cases")
    fn = lib.conv3x3_fwd_shared_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_size_t
    fwd_cases = [(bn, fm, seg, w) for bn, fm in cuda_conv.FWD_TILES
                 for seg, w in ((64, 64), (8, 8), (64, 700), (1, 1))]
    for args in fwd_cases:
        if fn(*args) != cuda_conv.fwd_shared_bytes(*args):
            raise AssertionError(f"conv3x3_fwd_shared_bytes{args}: kernel asks "
                                 f"{fn(*args)} bytes, the plan counts "
                                 f"{cuda_conv.fwd_shared_bytes(*args)}")
    print(f"conv3x3_fwd_shared_bytes equal to the plan's count at "
          f"{len(fwd_cases)} cases")
    fn = lib.conv3x3_dw_shared_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_size_t
    for rows, w, cin, cout in ((4, 64, 64, 64), (8, 64, 32, 16), (16, 64, 3, 16),
                               (8, 8, 128, 128), (1, 1, 16, 1)):
        want = cuda_conv.dw_shared_bytes(rows, w, cin, cout)
        if fn(rows, w, cin, cout) != want:
            raise AssertionError(f"conv3x3_dw_shared_bytes({rows}, {w}, {cin}, "
                                 f"{cout}): kernel asks {fn(rows, w, cin, cout)} "
                                 f"bytes, the plan counts {want}")
    print("conv3x3_dw_shared_bytes equal to the plan's count at 5 shapes")


def _plate(h: int, w: int | None = None) -> np.ndarray:
    w = h if w is None else w
    m = np.zeros((h, w), np.float32)
    m[h // 2, w // 4:w // 2] = 1.0
    return m


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int) -> float:
    """Device time per call of `fn`: `reps` calls captured in one CUDA graph
    and replayed, so that the host's cost per call, which exceeds the device
    time of the smaller convs, stays out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # handles and workspaces are made outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------------- bounds
# The least time the card could take for a kernel's work: the larger of its
# bytes (each input read once, each output written once) over the HBM rate
# and its fp32 operations over the fp32 rate. Operations are counted from
# the shapes and this run's trip counts.


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _cg_flops(h: int, w: int, iters: torch.Tensor) -> float:
    """The solves' operations: per trip four basis products (4hw(h+w)) and
    about 30 elementwise operations per cell; one more preconditioner
    application starts each solve."""
    return float((iters.double() + 1).sum()) * (4 * h * w * (h + w) + 30 * h * w)


def _geom_bytes(h: int, w: int) -> int:
    """The masks, 1/lambda and the two bases."""
    return 4 * ((h + 1) * w + h * (w + 1) + 2 * h * w + h * h + w * w)


def _window_cells(b: int, h: int, w: int) -> int:
    """Output cells of the three advection windows (rho, vy, vx)."""
    return b * (h * w + (h + 1) * w + h * (w + 1))


def _window_flops(adjoint: bool) -> int:
    """Operations per output cell of one advection window, counted from the
    taps that carry weight: the clipped hat window is a bilinear sample,
    t = 2 taps per axis of its 2k+2. Forward: the clip, the floor, the
    fraction and the two weights (5 per axis) and the factored sum
    (t² + t multiply-adds). The adjoint: the same weights, the hat's and the
    clip's derivatives (3 per axis), the two displacement cotangents
    (2t² + 2t multiply-adds and 2t products g·w) and the field cotangent
    (t² products g·w·w and t² adds)."""
    t = 2
    if adjoint:
        return 10 + 6 + 2 * (2 * t * t + 2 * t) + 2 * t + 2 * t * t
    return 10 + 2 * (t * t + t)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


# ---------------------------------------------------------------- phase 3


# K1's grids: (n, closed). The main path's, an open box, a grid its bands
# do not divide evenly and the largest its gate holds to plain.
K1_SHAPES = ((H, True), (32, False), (48, True), (96, True))
CG_GOLDENS = "tests/goldens/pcg_32.npz"


def cg_golden_check(dev) -> float:
    """K1 under its plan and every plan its launcher takes against the JAX
    package's solve, from the goldens of `scripts/make_cg_goldens.py`
    (32², batch 2, closed cold and warm, open cold): the pressure within
    1e-4 of the golden's max|p|. Returns the largest max|dp|."""
    from pathlib import Path

    from pde_control_tpu_torch.ops import cuda_cg

    z = np.load(Path(__file__).resolve().parent / CG_GOLDENS)
    kw = json.loads(str(z["config"]))

    def t(key):
        return torch.tensor(z[key].astype(np.float32), device=dev)

    worst = 0.0
    for case in ("closed-cold", "closed-warm", "open-cold"):
        closed = case.startswith("closed")
        box = "closed" if closed else "open"
        geom = [t(f"{box}/{k}") for k in ("acc_y", "acc_x", "fluid")]
        x0 = t("x0") if case.endswith("warm") else None
        want = t(f"{case}/p")
        rel = 0.0
        plans = cuda_cg.solve_plans(32, 32)
        for plan in [None] + plans:
            p, _ = cuda_cg._launch_solve(t("div"), *geom, x0, plan,
                                         closed=closed, precond=True, **kw)
            d = float((p - want).abs().max())
            worst, rel = max(worst, d), max(rel, d / float(want.abs().max()))
        print(f"golden 32x32x2 {case} (JAX interpret-mode kernel): K1 worst "
              f"max|dp|/max|p| over its plan and {len(plans)} others {rel:.2e}")
        if rel > 1e-4:
            raise AssertionError(f"K1 differs from the JAX golden {case}: "
                                 f"{rel:.3e} > 1e-4")
    return worst


def kernel_phase(card: str) -> dict:
    _phase("K1 (pressure solve) against plain and JAX")
    from pde_control_tpu_torch.grids import Domain2D
    from pde_control_tpu_torch.ops import cuda_cg
    from pde_control_tpu_torch.physics.poisson import (
        _projector,
        masked_laplace_spd,
        solve_pressure,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    summary = {}
    print("limits, under solve_plan's plan and under every plan the launcher "
          "takes: kernel residual <= max(2*tol, 2*plain residual); "
          "max|dp|/max|p| <= 100*tol; trip counts within 3 of plain; "
          "gradient max|dg|/max|g| <= 1e-3")
    for n, closed in K1_SHAPES:
        domain = Domain2D.create(n, n, obstacle_mask=_plate(n), closed=closed,
                                 device=dev)
        geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
        fluid = domain.fluid_mask > 0
        div = torch.tensor(rng.normal(size=(BATCH, n, n)), dtype=torch.float32,
                           device=dev)
        b = torch.where(fluid, -div, 0.0)  # the solve's rhs
        if closed:
            b = _projector(domain)(b)
        p_prev, _ = cuda_cg.pcg_plain(div, *geom, closed=closed, tol=1e-6,
                                      maxiter=500)
        noise = torch.tensor(rng.normal(size=(BATCH, n, n)), dtype=torch.float32,
                             device=dev)
        x0 = (p_prev + 0.05 * p_prev.std() * noise).contiguous()
        plans = cuda_cg.solve_plans(n, n)

        def rel_res(p):
            r = torch.where(fluid, b - masked_laplace_spd(p, domain), 0.0)
            return float((r.norm(dim=(1, 2)) / b.norm(dim=(1, 2))).max())

        for tol, maxiter in ((1e-4, 100), (1e-6, 500)):
            for start, guess in (("cold", None), ("warm", x0)):
                args = dict(x0=guess, dx=domain.dx, closed=closed, tol=tol,
                            maxiter=maxiter)
                p_p, it_p = cuda_cg.pcg_plain(div, *geom, **args)
                res_p = rel_res(p_p)
                label = f"{n}x{n} {'closed' if closed else 'open'} {start} tol={tol:g}"
                worst = {}
                for plan in [None] + plans:
                    if plan is None:
                        p_k, it_k = cuda_cg.pressure_solve(div, *geom, **args)
                    else:
                        p_k, it_k = cuda_cg._launch_solve(
                            div, *geom, guess, plan, precond=True,
                            **{k: v for k, v in args.items() if k != "x0"})
                    torch.cuda.synchronize()
                    err = float((p_k - p_p).abs().max())
                    rel = err / float(p_p.abs().max())
                    res_k = rel_res(p_k)
                    dit = int((it_k - it_p).abs().max())
                    if plan is None:
                        print(f"{label}: rel_residual kernel={res_k:.3e} "
                              f"plain={res_p:.3e} | max|dp|/max|p|={rel:.3e} | "
                              f"iters kernel={it_k.tolist()} plain={it_p.tolist()}")
                        p_main = p_k
                    if not torch.isfinite(p_k).all():
                        raise AssertionError(f"{label} {plan}: non-finite values")
                    if res_k > max(2.0 * tol, 2.0 * res_p):
                        raise AssertionError(f"{label} {plan}: kernel residual "
                                             f"{res_k:.3e} above tol {tol:g}")
                    if rel > 100 * tol:
                        raise AssertionError(f"{label} {plan}: kernel differs "
                                             f"from plain by {rel:.3e}")
                    if dit > 3:
                        raise AssertionError(f"{label} {plan}: trip counts "
                                             f"differ by {dit} > 3")
                    for key, v in (("rel", rel), ("res", res_k), ("dit", dit)):
                        worst[key] = max(worst.get(key, 0), v)
                print(f"  {len(plans)} plans: worst max|dp|/max|p| "
                      f"{worst['rel']:.2e}, residual {worst['res']:.2e}, trip "
                      f"counts within {worst['dit']}")
                if n == H and tol == 1e-4:
                    kernel_ms = _time_ms(
                        lambda: cuda_cg.pressure_solve(div, *geom, **args), 50)
                    plain_ms = _time_ms(
                        lambda: cuda_cg.pcg_plain(div, *geom, **args), 5)
                    it_k = cuda_cg.pressure_solve(div, *geom, **args)[1]
                    nbytes = (_nbytes(div, guess, p_main) + 4 * BATCH
                              + _geom_bytes(n, n))
                    bound_ms, bound_by = _bound(nbytes, _cg_flops(n, n, it_k))
                    print(f"  time per solve {n}x{n}x{BATCH} {start}: kernel "
                          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                          f"{bound_ms:.6f} ms ({bound_by}) [{card}]")
                    summary[start] = dict(err=float((p_main - p_p).abs().max()),
                                          ms=kernel_ms, plain_ms=plain_ms,
                                          bound_ms=bound_ms, bound_by=bound_by)

        # The gradient of sum(w * p) through the solve, kernel against plain.
        w = torch.tensor(rng.normal(size=(BATCH, n, n)), dtype=torch.float32,
                         device=dev)
        grads = {}
        for backend in ("cuda", "pcg"):
            d = div.clone().requires_grad_(True)
            p = solve_pressure(d, domain, tol=1e-6, maxiter=500, backend=backend,
                               x0=x0)
            (p * w).sum().backward()
            grads[backend] = d.grad
        g_err = float((grads["cuda"] - grads["pcg"]).abs().max()
                      / grads["pcg"].abs().max())
        print(f"{n}x{n} grad of sum(w*p): max|g_cuda-g_pcg|/max|g_pcg|="
              f"{g_err:.3e}")
        if g_err > 1e-3:
            raise AssertionError(f"gradient through the kernel differs: {g_err:.3e}")
    golden = cg_golden_check(dev)
    summary["cold"]["err"] = max(summary["cold"]["err"], golden)

    # Times at batch 64 (the main path's step, tol 1e-4 / maxiter 100), and
    # each batch's plan.
    domain = Domain2D.create(H, H, obstacle_mask=_plate(H), device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    div = torch.tensor(rng.normal(size=(64, H, H)), dtype=torch.float32,
                       device=dev)
    p64 = cuda_cg.pcg_plain(div, *geom, tol=1e-6, maxiter=500)[0]
    x64 = (p64 + 0.05 * p64.std() * torch.tensor(
        rng.normal(size=(64, H, H)), dtype=torch.float32, device=dev)).contiguous()
    for start, guess in (("cold", None), ("warm", x64)):
        args = dict(x0=guess, dx=domain.dx, closed=True, tol=1e-4, maxiter=100)
        ms64 = _time_ms(lambda: cuda_cg.pressure_solve(div, *geom, **args), 50)
        trips = cuda_cg.pressure_solve(div, *geom, **args)[1]
        print(f"  time per solve {H}x{H}x64 {start} (trips mean "
              f"{float(trips.float().mean()):.2f}): kernel {ms64:.4f} ms [{card}]")
    for batch in (BATCH, 64):
        print(f"  K1 plan at {H}x{H}x{batch}: "
              f"{_plan_text(cuda_cg.solve_plan(batch, H, H))}")
    summary["cold"]["plan"] = dict(cuda_cg.solve_plan(BATCH, H, H)._asdict(),
                                   batch=BATCH)
    return summary


# ---------------------------------------------------------------- phase 4

# Every case carries a force: (warm start, inflow, zero velocity, a NaN in
# sample 0's vy and an infinity in sample 1's vx).
FUSED_CASES = {
    "cold": (False, False, False, False),
    "warm": (True, False, False, False),
    "warm-inflow": (True, True, False, False),
    "zero-velocity": (False, False, True, False),
    "non-finite": (False, False, False, True),
}
FUSED_STEP = dict(dt=1.0, max_shift=2, buoyancy=0.08, closed=True)


# K2 and K3 are checked under every plan their launchers take at these
# grids: the main path's, a smaller square, two that are not square (one of
# a width that is not a multiple of 4) and one row a rank under C = 8.
FUSED_SHAPES = ((H, H), (32, 32), (32, 48), (24, 30), (8, 8))
GOLDENS = "tests/goldens/fused_step_32.npz"


def _fused_operands(rng, h, w, case, domain, dev, batch=BATCH):
    """The step's operands and the four output cotangents, from `rng`."""
    from pde_control_tpu_torch.ops import cuda_fluid

    warm, inflow, zero_v, nonfinite = FUSED_CASES[case]

    def t(shape, scale=1.0, uniform=False):
        a = rng.uniform(0, 1, shape) if uniform else rng.normal(size=shape)
        return torch.tensor(scale * a, dtype=torch.float32, device=dev)

    v = 0.0 if zero_v else 0.5
    yf, xf, c = (batch, h + 1, w), (batch, h, w + 1), (batch, h, w)
    ops = dict(vy=t(yf, v), vx=t(xf, v), rho=t(c, uniform=True),
               fy=t(yf, 0.05), fx=t(xf, 0.05))
    if nonfinite:
        ops["vy"][0, h // 2, w // 3] = float("nan")
        ops["vx"][1, h // 3, w // 2] = float("inf")
    if inflow:
        ops["inflow"] = t(c, 0.05, uniform=True)
    if warm:  # a guess near this step's pressure, as the previous step's is
        p = cuda_fluid.fused_step_plain_forward(
            *(ops[k] for k in ("vy", "vx", "rho")), domain.acc_y, domain.acc_x,
            domain.fluid_mask, fy=ops["fy"], fx=ops["fx"], inflow=ops.get("inflow"),
            dx=domain.dx, tol=1e-6, maxiter=500, **FUSED_STEP)[3]
        ops["x0"] = (p + 0.05 * p.std() * t(c)).contiguous()
    return ops, [t(yf), t(xf), t(c), t(c)]


def _plan_text(plan) -> str:
    return (f"cluster {plan.cluster} x {plan.threads} threads, "
            f"{plan.rows_per_rank} rows a rank, {plan.shared_bytes} B shared")


def _agree(label: str, got, want, names, limit: float, nonfinite: bool) -> tuple:
    """Each output within `limit` of the reference's max|ref| over its
    finite cells, the non-finite cells exactly the reference's (none unless
    `nonfinite`), trip counts within 3 when both sides return them. Returns
    ({name: max|d|/max|ref|}, the largest max|d|, the non-finite cells)."""
    rels, worst, n_bad = {}, 0.0, 0
    for name, a, b in zip(names, got, want):
        if (a is None) != (b is None):
            raise AssertionError(f"{label} {name}: one side is None")
        if a is None:
            continue
        fin = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), fin):
            raise AssertionError(f"{label} {name}: non-finite cells differ")
        n_bad += int((~fin).sum())
        d = float((a[fin] - b[fin]).abs().max())
        worst = max(worst, d)
        rels[name] = d / max(float(b[fin].abs().max()), 1e-30)
    if (n_bad > 0) != nonfinite:
        raise AssertionError(f"{label}: {n_bad} non-finite cells")
    bad = {k: v for k, v in rels.items() if v > limit}
    if bad:
        raise AssertionError(f"{label}: {bad} > {limit}")
    if len(got) > len(names) and len(want) > len(names):
        dit = int((got[-1] - want[-1]).abs().max())
        if dit > 3:
            raise AssertionError(f"{label}: trip counts differ by {dit} > 3")
    return rels, worst, n_bad


def _same_bits(label: str, a: tuple, b: tuple) -> None:
    for x, y in zip(a, b):
        if x is not None and not torch.equal(x.view(torch.int32), y.view(torch.int32)):
            raise AssertionError(f"{label}: two calls differ")


def fused_golden_check(dev) -> dict:
    """K2 and K3 (each under its plan and every plan its launcher takes at
    32²) against the JAX package's fused step and VJP, from the goldens
    of `scripts/make_fused_goldens.py`: outputs within 1e-4, cotangents
    within 1e-3 of the golden's max|ref|."""
    from pathlib import Path

    from pde_control_tpu_torch.ops import cuda_fluid

    z = np.load(Path(__file__).resolve().parent / GOLDENS)
    cfg = json.loads(str(z["config"]))
    kw = {k: cfg[k] for k in ("dt", "dx", "max_shift", "buoyancy", "closed",
                              "tol", "maxiter")}

    def t(key):
        return torch.tensor(z[key].astype(np.float32), device=dev)

    geom = tuple(t(k) for k in ("acc_y", "acc_x", "fluid"))
    cots = [t(k) for k in ("g_vy4", "g_vx4", "g_rho1", "g_p")]
    err = {"fwd": 0.0, "bwd": 0.0}
    for case in ("warm-force-inflow", "zero-velocity"):
        zero_v = case == "zero-velocity"
        vy, vx = (torch.zeros_like(t(k)) if zero_v else t(k) for k in ("vy", "vx"))
        rho, fy, fx = t("rho"), t("fy"), t("fx")
        inflow, x0 = (None, None) if zero_v else (t("inflow"), t("x0"))
        names_f = ("vy4", "vx4", "rho1", "p")
        want = [t(f"{case}/{n}") for n in names_f]
        rel_f = 0.0
        for plan in [None] + cuda_fluid.fwd_plans(32, 32):
            out = cuda_fluid._launch_forward(vy, vx, rho, *geom, fy, fx, inflow,
                                             x0, plan, **kw)
            rels, worst, _ = _agree(f"golden {case} fwd {plan}", out[:4], want,
                                    names_f, 1e-4, False)
            err["fwd"] = max(err["fwd"], worst)
            rel_f = max(rel_f, max(rels.values()))
        names_b = ("vy", "vx", "rho", "fy", "fx", "inflow")
        want = [None if zero_v and n == "inflow" else t(f"{case}/d_{n}")
                for n in names_b]
        rel_b = 0.0
        for plan in [None] + cuda_fluid.bwd_plans(32, 32):
            got = cuda_fluid._launch_backward(vy, vx, rho, *cots, *geom, plan,
                                              has_force=True, has_inflow=not zero_v,
                                              **kw)
            rels_b, worst, _ = _agree(f"golden {case} bwd {plan}", got[:6], want,
                                      names_b, 1e-3, False)
            err["bwd"] = max(err["bwd"], worst)
            rel_b = max(rel_b, max(rels_b.values()))
        print(f"golden 32x32x2 {case} (JAX interpret-mode kernels): worst "
              f"max|d|/max|ref| over the plan and every other: K2 {rel_f:.2e} "
              f"({len(cuda_fluid.fwd_plans(32, 32))} plans), K3 {rel_b:.2e} "
              f"({len(cuda_fluid.bwd_plans(32, 32))} plans)")
    return err


def fused_kernel_phase(card: str) -> dict:
    _phase("K2 / K3 (fused step forward / backward) against plain and JAX")
    from pde_control_tpu_torch.grids import Domain2D
    from pde_control_tpu_torch.ops import cuda_fluid

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    print("limits at tol 1e-6 / maxiter 500: each K2 output max|d|/max|ref| "
          "<= 1e-4, trip counts within 3; each K3 cotangent max|d|/max|ref| "
          "<= 1e-3, trip counts within 3; each under its plan and under "
          "every plan its launcher takes, the same bits in two calls; "
          "non-finite cells exactly the plain version's (none but in the "
          "non-finite case), errors over the finite cells")
    names_f = ("vy4", "vx4", "rho1", "p")
    names_b = ("g_vy", "g_vx", "g_rho", "g_fy", "g_fx", "g_inflow")
    err = {"fwd": 0.0, "bwd": 0.0}
    for h, w in FUSED_SHAPES:
        domain = Domain2D.create(h, w, obstacle_mask=_plate(h, w), device=dev)
        geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
        plans = cuda_fluid.bwd_plans(h, w)
        fwd_plans = cuda_fluid.fwd_plans(h, w)
        for case in FUSED_CASES:
            label = f"{h}x{w} {case}"
            nonfinite = case == "non-finite"
            ops, cots = _fused_operands(rng, h, w, case, domain, dev)
            kw = dict(FUSED_STEP, dx=domain.dx, tol=1e-6, maxiter=500)
            state = (ops.pop("vy"), ops.pop("vx"), ops.pop("rho"))
            out_k = cuda_fluid.fused_step_forward(*state, *geom, **ops, **kw)
            out_p = cuda_fluid.fused_step_plain_forward(*state, *geom, **ops,
                                                        **kw)
            rels, worst, n_bad = _agree(f"{label} fwd", out_k, out_p, names_f,
                                        1e-4, nonfinite)
            err["fwd"] = max(err["fwd"], worst)
            worst_rel, trips = 0.0, set()
            step_ops = [ops.get(k) for k in ("fy", "fx", "inflow", "x0")]
            for plan in fwd_plans:
                got, again = (cuda_fluid._launch_forward(
                    *state, *geom, *step_ops, plan, **kw) for _ in range(2))
                r, d, _ = _agree(f"{label} fwd {plan}", got, out_p, names_f,
                                 1e-4, nonfinite)
                _same_bits(f"{label} fwd {plan}", got, again)
                err["fwd"] = max(err["fwd"], d)
                worst_rel = max(worst_rel, max(r.values()))
                trips.add(tuple(got[-1].tolist()))
            plan = cuda_fluid.fwd_plan(BATCH, h, w)
            print(f"{label} fwd ({_plan_text(plan)}): " + " ".join(
                f"{k}={v:.2e}" for k, v in rels.items())
                + f" | non-finite cells {n_bad} | iters kernel="
                f"{out_k[-1].tolist()} plain={out_p[-1].tolist()} | "
                f"{len(fwd_plans)} plans: worst {worst_rel:.2e}, {len(trips)} "
                "distinct trip counts, each the same bits in two calls")
            flags = dict(has_force=True, has_inflow="inflow" in ops)
            g_p = cuda_fluid.fused_step_plain_backward(*state, *cots, *geom,
                                                       **flags, **kw)
            g_k = cuda_fluid.fused_step_backward(*state, *cots, *geom, **flags,
                                                 **kw)
            rels, worst, n_bad = _agree(f"{label} bwd", g_k, g_p, names_b, 1e-3,
                                        nonfinite)
            err["bwd"] = max(err["bwd"], worst)
            worst_rel, trips = 0.0, set()
            for plan in plans:
                got = cuda_fluid._launch_backward(*state, *cots, *geom, plan,
                                                  **flags, **kw)
                again = cuda_fluid._launch_backward(*state, *cots, *geom, plan,
                                                    **flags, **kw)
                r, d, _ = _agree(f"{label} bwd {plan}", got, g_p, names_b, 1e-3,
                                 nonfinite)
                _same_bits(f"{label} bwd {plan}", got, again)
                err["bwd"] = max(err["bwd"], d)
                worst_rel = max(worst_rel, max(r.values()))
                trips.add(tuple(got[-1].tolist()))
            plan = cuda_fluid.bwd_plan(BATCH, h, w, FUSED_STEP["max_shift"])
            print(f"{label} bwd ({_plan_text(plan)}): " + " ".join(
                f"{k}={v:.2e}" for k, v in rels.items())
                + f" | non-finite cells {n_bad} | iters kernel="
                f"{g_k[-1].tolist()} plain={g_p[-1].tolist()} | {len(plans)} "
                f"plans: worst {worst_rel:.2e}, {len(trips)} distinct trip "
                "counts, each the same bits in two calls")
    golden = fused_golden_check(dev)
    for key in err:
        err[key] = max(err[key], golden[key])

    # Times at the main path's settings: 64², force, warm start, tol 1e-4;
    # also at maxiter 0 (the rest without the CG trips) and at batch 64.
    domain = Domain2D.create(H, H, obstacle_mask=_plate(H), device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    ops, cots = _fused_operands(rng, H, H, "warm", domain, dev)
    kw = dict(FUSED_STEP, dx=domain.dx, tol=1e-4, maxiter=100)
    state = (ops.pop("vy"), ops.pop("vx"), ops.pop("rho"))
    flags = dict(has_force=True, has_inflow=False)
    out = cuda_fluid.fused_step_forward(*state, *geom, **ops, **kw)
    grads = cuda_fluid.fused_step_backward(*state, *cots, *geom, **flags, **kw)

    def bwd(maxiter=100, args=(state, cots)):
        return cuda_fluid.fused_step_backward(*args[0], *args[1], *geom, **flags,
                                              **dict(kw, maxiter=maxiter))

    def fwd(maxiter=100, args=(state, ops)):
        return cuda_fluid.fused_step_forward(*args[0], *geom, **args[1],
                                             **dict(kw, maxiter=maxiter))

    timed = {
        "fwd": (fwd, lambda: cuda_fluid.fused_step_plain_forward(
            *state, *geom, **ops, **kw)),
        "bwd": (bwd, lambda: cuda_fluid.fused_step_plain_backward(
            *state, *cots, *geom, **flags, **kw)),
    }
    cells = _window_cells(BATCH, H, H)
    work = {
        "fwd": (_nbytes(*state, *ops.values(), *out[:4]) + 4 * BATCH,
                cells * (_window_flops(False) + 20)
                + _cg_flops(H, H, out[4])),
        "bwd": (_nbytes(*state, *cots, *grads[:6]) + 4 * BATCH,
                cells * (_window_flops(True) + 20)
                + _cg_flops(H, H, grads[6])),
    }
    summary = {}
    for where, (kernel, plain) in timed.items():
        # Events over a host loop: the yardstick of every recorded K1-K3
        # time. Graph replay, which leaves the host out, beside it.
        kernel_ms, plain_ms = _time_ms(kernel, 50), _time_ms(plain, 5)
        graph_ms = _graph_ms(kernel, 20)
        nbytes, flops = work[where]
        bound_ms, bound_by = _bound(nbytes + _geom_bytes(H, H), flops)
        iters = (out if where == "fwd" else grads)[-1]
        print(f"  time per {where} launch {H}x{H}x{BATCH} warm, tol 1e-4 "
              f"(trips {iters.tolist()}): kernel {kernel_ms:.4f} ms"
              + (f" (graph replay {graph_ms:.4f})" if graph_ms else "")
              + f", plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}; "
              f"{flops / 1e6:.1f} MFLOP, {nbytes / 1e6:.2f} MB) [{card}]")
        summary[where] = dict(err=err[where], ms=kernel_ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        if graph_ms:
            summary[where]["graph_ms"] = graph_ms
    ops64, cots64 = _fused_operands(rng, H, H, "warm", domain, dev, batch=64)
    state64 = (ops64.pop("vy"), ops64.pop("vx"), ops64.pop("rho"))
    for name, where, fn, args64, plan_of in (
            ("K2", "fwd", fwd, (state64, ops64), cuda_fluid.fwd_plan),
            ("K3", "bwd", bwd, (state64, cots64),
             lambda b, h, w: cuda_fluid.bwd_plan(b, h, w, FUSED_STEP["max_shift"]))):
        plan = plan_of(BATCH, H, H)
        # By graph replay: at maxiter 0 a host loop times the enqueue.
        rest_ms = _graph_ms(lambda: fn(0), 20)
        ms64 = _time_ms(lambda: fn(args=args64), 50)
        trips64 = fn(args=args64)[-1]
        print(f"  {name} plan at {H}x{H}x{BATCH}: {_plan_text(plan)}; at maxiter "
              f"0 (no CG trip) {rest_ms:.4f} ms by graph replay, so the trips "
              f"take {summary[where]['graph_ms'] - rest_ms:.4f} ms [{card}]")
        print(f"  {name} at {H}x{H}x64 ({_plan_text(plan_of(64, H, H))}; trips "
              f"mean {float(trips64.float().mean()):.2f}): {ms64:.4f} ms per "
              f"launch [{card}]")
        summary[where]["plan"] = dict(plan._asdict(), batch=BATCH)
    return summary


# --------------------------------------------------------------- phase 10


def _conv_work(b: int, h: int, w: int, cin: int, cout: int) -> tuple[float, dict]:
    """Operations of one direction of the conv (2·M·N·K with M = B·H·W,
    N = Cout, K = 9·Cin; the same for forward, dX and dW) and each
    direction's bf16 bytes, each input read once and each output written
    once."""
    m, wts = b * h * w, 9 * cin * cout
    return 2.0 * m * cout * 9 * cin, {
        "fwd": 2 * (m * cin + wts + cout + m * cout),
        "dx": 2 * (m * cout + wts + m * cin),
        "dw": 2 * (m * cin + m * cout + wts)}


def _dw_bound_with_partials(key: tuple, plan) -> float:
    """K5's bound in ms when the fp32 partials of its plan, written by the
    first pass and read by the second, are counted with the operands."""
    flops, nbytes = _conv_work(*key)
    return 1e3 * max((nbytes["dw"] + 2 * plan.partial_bytes) / PEAK_HBM_BYTES,
                     flops / PEAK_BF16_TC_FLOPS)


def _fwd_plan_text(plan) -> str:
    return (f"bn {plan.bn} x fm {plan.fm} x seg {plan.seg} x splits "
            f"{plan.splits} ({plan.blocks} blocks, {plan.shared_bytes} B "
            f"shared, {plan.partial_bytes} B partials)")


# The conv goldens' files and their cases: the main path's widths, and the
# indirect-smoke task's CFE widths (BASELINE config 4).
CONV_GOLDENS = {"tests/goldens/conv3x3_32.npz": ("5-32", "64-64", "16-16",
                                                 "32-16"),
                "tests/goldens/conv3x3_32_wide.npz": ("6-48", "48-96", "96-96",
                                                      "96-48")}


def conv_golden_check(dev) -> dict:
    """K4 (forward, dX) and K5 under the wrappers' plans and every plan
    their launchers take (`fwd_plans`, `dw_plans`) against the JAX
    package's bf16 conv and VJP, from the goldens of
    `scripts/make_conv_goldens.py` (32², batch 2, with a bias: 5 → 32,
    64 → 64, 16 → 16, 32 → 16, and config 4's 6 → 48, 48 → 96, 96 → 96,
    96 → 48): each within 1e-2 of the golden's max|ref|. Returns the
    largest max|d| of K4 and of K5."""
    from pathlib import Path

    from pde_control_tpu_torch.ops import cuda_conv

    worst = {"K4": 0.0, "K5": 0.0}
    for path, case in [(p, c) for p, cases in CONV_GOLDENS.items()
                       for c in cases]:
        z = np.load(Path(__file__).resolve().parent / path)
        cin, cout = map(int, case.split("-"))
        x, k, b, g = (torch.tensor(z[f"{case}/{n}"].astype(np.float32),
                                   device=dev).to(torch.bfloat16) for n in "xkbg")
        wflat = k.reshape(9 * cin, cout)
        want = {n: torch.from_numpy(z[f"{case}/{n}"].view(np.int16)).view(
            torch.bfloat16).float().to(dev) for n in ("y", "dx", "dw")}

        def launch(d, plan):
            if d == "y":
                return cuda_conv._fwd_launch("forward", x, wflat, b, cin, cout,
                                             False, plan)
            if d == "dx":
                return cuda_conv._fwd_launch("dX", g, wflat, None, cout, cin,
                                             True, plan)
            return cuda_conv._dw_launch(x, g, plan or cuda_conv.dw_plan(
                2, 32, 32, cin, cout)).reshape(k.shape)

        plans = {"y": cuda_conv.fwd_plans(2, 32, 32, cin, cout),
                 "dx": cuda_conv.fwd_plans(2, 32, 32, cout, cin),
                 "dw": cuda_conv.dw_plans(2, 32, 32, cin, cout)}
        rel = dict.fromkeys(plans, 0.0)
        for d, others in plans.items():
            scale = float(want[d].abs().max())
            for plan in [None] + others:
                diff = float((launch(d, plan).float() - want[d]).abs().max())
                kernel = "K5" if d == "dw" else "K4"
                worst[kernel] = max(worst[kernel], diff)
                rel[d] = max(rel[d], diff / scale)
                if diff > 1e-2 * scale:
                    raise AssertionError(f"conv golden {case} {d} {plan}: max|d|/"
                                         f"max|ref| {diff / scale:.3e} > 1e-2")
        print(f"golden 32x32x2 {case} (JAX interpret-mode kernels): worst "
              f"max|d|/max|ref| over the wrappers' plan and every other: "
              + ", ".join(f"{d} {rel[d]:.2e} ({len(plans[d]) + 1} plans)"
                          for d in plans))
    return worst


# (batch, H, W, Cin, Cout) of config 4's CFE (widths 48-96-96-48, six
# input channels) at 64², in training (batch 8) and in the eval (batch 16).
CONFIG4_CONV_SHAPES = [(b, 64, 64, cin, cout) for b in (8, 16)
                       for cin, cout in ((6, 48), (48, 96), (96, 96),
                                         (96, 48), (48, 1))]


def config4_conv_check(dev, rng, err: dict) -> None:
    """K4 (forward, dX) and K5 against their plain versions at config 4's
    CFE shapes, under the wrappers' plan and every plan `fwd_plans` and
    `dw_plans` list: y and dX within 1e-2 of max|ref|, dW within 2e-2."""
    from pde_control_tpu_torch.ops import cuda_conv

    for key in CONFIG4_CONV_SHAPES:
        b, h, w, cin, cout = key
        x, g = (torch.tensor(rng.normal(size=(b, h, w, c)), dtype=torch.float32,
                             device=dev).to(torch.bfloat16) for c in (cin, cout))
        wflat = torch.tensor(rng.normal(size=(9 * cin, cout)) / np.sqrt(9 * cin),
                             dtype=torch.float32, device=dev).to(torch.bfloat16)
        bias = torch.tensor(0.1 * rng.normal(size=cout), dtype=torch.float32,
                            device=dev).to(torch.bfloat16)
        cases = (
            ("fwd", 1e-2, cuda_conv.conv3x3_plain(x, wflat, bias),
             [None] + cuda_conv.fwd_plans(b, h, w, cin, cout),
             lambda p: cuda_conv._fwd_launch("forward", x, wflat, bias, cin,
                                             cout, False, p)),
            ("dx", 1e-2, cuda_conv.conv3x3_plain(
                g, cuda_conv.rotate_weights(wflat)),
             [None] + cuda_conv.fwd_plans(b, h, w, cout, cin),
             lambda p: cuda_conv._fwd_launch("dX", g, wflat, None, cout, cin,
                                             True, p)),
            ("dw", 2e-2, cuda_conv.conv3x3_dw_plain(x, g),
             [None] + cuda_conv.dw_plans(*key),
             lambda p: cuda_conv._dw_launch(x, g, p or cuda_conv.dw_plan(*key))))
        rels = {}
        for d, limit, want, plans, launch in cases:
            want = want.float()
            scale = max(float(want.abs().max()), 1e-30)
            rels[d] = 0.0
            for plan in plans:
                got = launch(plan).float().reshape(want.shape)
                diff = float((got - want).abs().max())
                err["K5" if d == "dw" else "K4"] = max(
                    err["K5" if d == "dw" else "K4"], diff)
                rels[d] = max(rels[d], diff / scale)
                if not (diff <= limit * scale and torch.isfinite(got).all()):
                    raise AssertionError(f"config 4 {key} {d} {plan}: max|d|/"
                                         f"max|ref| {diff / scale:.3e} > {limit}")
            rels[d] = f"{rels[d]:.2e} ({len(plans)} plans)"
        print(f"config 4 {b}x{h}x{w} {cin}->{cout} against plain, worst over "
              f"every plan: " + ", ".join(f"{d} {v}" for d, v in rels.items()))


def conv_kernel_phase(card: str, shapes: dict) -> dict:
    """K4 (forward and dX) and K5 (dW) against their plain versions, and db
    as `_Conv3x3` computes it, at every conv shape of the conv path's first
    iteration; then each direction's time per launch beside its plain
    version's, cuDNN's (timed as a yardstick; the port never calls it on
    this path) and its bound, and the sums over one iteration. Times are
    device times (`_graph_ms`)."""
    _phase("K4 / K5 (3x3 conv forward, dX, dW) against plain and JAX")
    import torch.nn.functional as F

    from pde_control_tpu_torch.ops import cuda_conv

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    print("limits: y, dX and db max|d|/max|ref| <= 1e-2 (one bf16 ulp is "
          "2^-8; the fp32 sums run in another order); dW <= 2e-2 (it sums "
          "2^15..2^18 products); y, dX and dW the same bits in two calls")
    err = conv_golden_check(dev)
    config4_conv_check(dev, rng, err)
    dirs = ("fwd", "dx", "dw")
    sums = {d: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                    t_bytes=0.0, t_ops=0.0, launches=0) for d in dirs}
    sums["dw"].update(bound_partials_ms=0.0, partial_bytes=0)
    for key in sorted(shapes):
        b, h, w, cin, cout = key
        per_iter = shapes[key]

        def t(*shape, scale=1.0):
            return torch.tensor(scale * rng.normal(size=shape),
                                dtype=torch.float32, device=dev).to(torch.bfloat16)

        x, g = t(b, h, w, cin), t(b, h, w, cout)
        wflat, bias = t(9 * cin, cout, scale=1 / np.sqrt(9 * cin)), t(cout, scale=0.1)
        kernel = {"fwd": lambda: cuda_conv.conv3x3_forward(x, wflat, bias),
                  "dx": lambda: cuda_conv.conv3x3_dx(g, wflat),
                  "dw": lambda: cuda_conv.conv3x3_dw(x, g)}
        plain = {"fwd": lambda: cuda_conv.conv3x3_plain(x, wflat, bias),
                 "dx": lambda: cuda_conv.conv3x3_plain(
                     g, cuda_conv.rotate_weights(wflat)),
                 "dw": lambda: cuda_conv.conv3x3_dw_plain(x, g)}
        xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        w_oihw = wflat.reshape(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous()
        library = {"fwd": lambda: F.conv2d(xn, w_oihw, bias, padding=1),
                   "dx": lambda: torch.nn.grad.conv2d_input(
                       xn.shape, w_oihw, gn, padding=1),
                   "dw": lambda: torch.nn.grad.conv2d_weight(
                       xn, w_oihw.shape, gn, padding=1)}
        got = {d: fn() for d, fn in kernel.items()}
        want = {d: fn() for d, fn in plain.items()}
        for d, fn in kernel.items():
            if not torch.equal(fn(), got[d]):
                raise AssertionError(f"{key} {d}: two calls differ")
        got["db"] = torch.sum(g, dim=(0, 1, 2), dtype=torch.float32).to(g.dtype)
        want["db"] = g.float().reshape(-1, cout).sum(0).to(g.dtype)
        torch.cuda.synchronize()
        rels = {}
        for d, limit in (("fwd", 1e-2), ("dx", 1e-2), ("dw", 2e-2), ("db", 1e-2)):
            a, r = got[d].float(), want[d].float()
            if a.shape != r.shape or not torch.isfinite(a).all():
                raise AssertionError(f"{key} {d}: shape {tuple(a.shape)} against "
                                     f"{tuple(r.shape)}, or non-finite values")
            diff = float((a - r).abs().max())
            if d != "db":
                err["K5" if d == "dw" else "K4"] = max(
                    err["K5" if d == "dw" else "K4"], diff)
            rels[d] = diff / max(float(r.abs().max()), 1e-30)
            if rels[d] > limit:
                raise AssertionError(f"{key} {d}: max|d|/max|ref| {rels[d]:.3e} > "
                                     f"{limit}")
        flops, nbytes = _conv_work(*key)
        times = []
        for d in dirs:
            ms, plain_ms = _graph_ms(kernel[d], 20), _graph_ms(plain[d], 3)
            library_ms = _graph_ms(library[d], 20)
            t_bytes, t_ops = nbytes[d] / PEAK_HBM_BYTES, flops / PEAK_BF16_TC_FLOPS
            bound_ms = 1e3 * max(t_bytes, t_ops)
            n = per_iter[d]
            for k, v in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", library_ms), ("bound_ms", bound_ms),
                         ("t_bytes", 1e3 * t_bytes), ("t_ops", 1e3 * t_ops),
                         ("launches", 1)):
                sums[d][k] += n * v
            times.append(f"{d} {ms:.4f} (plain {plain_ms:.4f}, cuDNN "
                         f"{library_ms:.4f}, bound {bound_ms:.6f} "
                         f"{'bytes' if t_bytes >= t_ops else 'operations'})")
        times.append("K4 plans " + "; ".join(
            f"{d} {_fwd_plan_text(cuda_conv.fwd_plan(b, h, w, ci, co))}"
            for d, ci, co in (("fwd", cin, cout), ("dX", cout, cin))))
        plan = cuda_conv.dw_plan(*key)
        with_partials = _dw_bound_with_partials(key, plan)
        sums["dw"]["bound_partials_ms"] += per_iter["dw"] * with_partials
        sums["dw"]["partial_bytes"] += per_iter["dw"] * plan.partial_bytes
        times.append(f"dW plan rows {plan.rows} x runs {plan.runs_per_block} x "
                     f"splits {plan.splits}, {plan.shared_bytes} B shared, "
                     f"{plan.partial_bytes} B partials, bound with partials "
                     f"{with_partials:.6f}")
        print(f"{b}x{h}x{w} {cin}->{cout}, per iteration fwd {per_iter['fwd']} "
              f"dX {per_iter['dx']} dW {per_iter['dw']}: max|d|/max|ref| "
              + " ".join(f"{k}={v:.2e}" for k, v in rels.items())
              + f" | {flops / 1e9:.3f} GFLOP | ms per launch: " + "; ".join(times)
              + f" [{card}]")
    for d in dirs:
        s = sums[d]
        print(f"{d} summed over one iteration ({s['launches']} launches): kernel "
              f"{s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, cuDNN "
              f"{s['library_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms [{card}]")
    print(f"dw bound with its partials written and read again "
          f"({sums['dw']['partial_bytes'] / 1e6:.1f} MB per iteration): "
          f"{sums['dw']['bound_partials_ms']:.4f} ms")

    print("K4 at the shapes its tiles, segments and splits could get wrong "
          "(not in the sums): y and dX max|d|/max|ref| <= 1e-2, the same bits "
          "in two calls")
    for key in K4_EDGE_SHAPES:
        b, h, w, cin, cout = key
        x, g = (torch.tensor(rng.normal(size=(b, h, w, c)), dtype=torch.float32,
                             device=dev).to(torch.bfloat16) for c in (cin, cout))
        wflat = torch.tensor(rng.normal(size=(9 * cin, cout)) / np.sqrt(9 * cin),
                             dtype=torch.float32, device=dev).to(torch.bfloat16)
        bias = torch.tensor(0.1 * rng.normal(size=cout), dtype=torch.float32,
                            device=dev).to(torch.bfloat16)
        rels = {}
        for d, fn, ref in (
                ("fwd", lambda: cuda_conv.conv3x3_forward(x, wflat, bias),
                 lambda: cuda_conv.conv3x3_plain(x, wflat, bias)),
                ("dx", lambda: cuda_conv.conv3x3_dx(g, wflat),
                 lambda: cuda_conv.conv3x3_plain(g, cuda_conv.rotate_weights(wflat)))):
            got, again, want = fn(), fn(), ref()
            torch.cuda.synchronize()
            diff = float((got.float() - want.float()).abs().max())
            err["K4"] = max(err["K4"], diff)
            rels[d] = diff / max(float(want.float().abs().max()), 1e-30)
            if not (got.shape == want.shape and torch.isfinite(got.float()).all()
                    and rels[d] <= 1e-2):
                raise AssertionError(f"{key} {d}: max|d|/max|ref| {rels[d]:.3e} "
                                     "> 1e-2, or a wrong shape or non-finite")
            if not torch.equal(got, again):
                raise AssertionError(f"{key} {d}: two calls differ")
        print(f"{b}x{h}x{w} {cin}->{cout}: y {rels['fwd']:.2e}, dX {rels['dx']:.2e}; "
              f"plans fwd {_fwd_plan_text(cuda_conv.fwd_plan(*key))}; dX "
              f"{_fwd_plan_text(cuda_conv.fwd_plan(b, h, w, cout, cin))}")

    print("K5 at the shapes its runs of whole rows could get wrong (not in "
          "the sums): dW max|d|/max|ref| <= 2e-2, the same bits in two calls")
    for key in K5_EDGE_SHAPES:
        b, h, w, cin, cout = key
        x, g = (torch.tensor(rng.normal(size=(b, h, w, c)), dtype=torch.float32,
                             device=dev).to(torch.bfloat16) for c in (cin, cout))
        got, want = cuda_conv.conv3x3_dw(x, g), cuda_conv.conv3x3_dw_plain(x, g)
        again = cuda_conv.conv3x3_dw(x, g)
        torch.cuda.synchronize()
        rel = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max().clamp_min(1e-30))
        err["K5"] = max(err["K5"], float((got.float() - want.float()).abs().max()))
        plan = cuda_conv.dw_plan(*key)
        ms = _graph_ms(lambda: cuda_conv.conv3x3_dw(x, g), 20)
        print(f"{b}x{h}x{w} {cin}->{cout}: dW {rel:.2e}, plan rows {plan.rows} x "
              f"runs {plan.runs_per_block} x splits {plan.splits}, {ms:.4f} ms "
              f"[{card}]")
        if not (rel <= 2e-2 and torch.isfinite(got.float()).all()):
            raise AssertionError(f"{key} dw: max|d|/max|ref| {rel:.3e} > 2e-2")
        if not torch.equal(got, again):
            raise AssertionError(f"{key} dw: two calls differ")

    def summary(parts, name):
        n = sum(sums[d]["launches"] for d in parts)
        out = {k: sum(sums[d][k] for d in parts) / n
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by_ops = sum(sums[d]["t_ops"] for d in parts)
        by_bytes = sum(sums[d]["t_bytes"] for d in parts)
        out.update(err=err[name], bound_by="operations" if by_ops >= by_bytes
                   else "bytes")
        return out

    return {"K4": summary(("fwd", "dx"), "K4"), "K5": summary(("dw",), "K5")}


# ------------------------------------------------------------ phases 5 to 8


def make_app(backend: str = "auto", fused: str = "auto", conv_impl: str = "xla",
             sequence_class: str = "staggered", **train):
    """The port's counterpart of `__graft_entry__._make_app(64, 16, 8)`
    (`fused='cuda'`: of `_make_app(64, 16, 8, fused='pallas')`;
    `conv_impl='cuda'`: of its `conv_impl='pallas'`); `sequence_class` and
    `train` (grad_clip, lr_schedule, …) go to `ControlTraining`."""
    from pde_control_tpu_torch import (
        ControlTraining,
        Domain2D,
        FluidConfig,
        IncompressibleFluidPDE,
    )

    dev = torch.device("cuda")
    domain = Domain2D.create(H, H, obstacle_mask=_plate(H), device=dev)
    cfg = FluidConfig(dt=1.0, buoyancy=0.08, pressure_tol=1e-4,
                      pressure_maxiter=100, warm_start_pressure=True,
                      pressure_backend=backend, fused=fused)
    pde = IncompressibleFluidPDE(domain, cfg, control="buoyancy",
                                 unet_levels=UNET_LEVELS,
                                 cfe_features=CFE_FEATURES, op_base_features=16,
                                 dtype=torch.bfloat16, conv_impl=conv_impl)
    return ControlTraining(
        N, pde,
        trainable_networks=("CFE",) + tuple(f"OP{s}" for s in SPANS),
        sequence_class=sequence_class, obs_loss_frames=(N,), seed=SEED,
        **train).prepare()


def make_batch(seed: int = SEED) -> dict:
    """`__graft_entry__._make_batch(64, 16, 8)`."""
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.uniform(0, 1, size=(BATCH, N + 1, H, H, 1)).astype(np.float32),
        "vy0": np.zeros((BATCH, H + 1, H), np.float32),
        "vx0": np.zeros((BATCH, H, H + 1), np.float32),
    }


def _grad_norms(app) -> dict:
    return {name: float(torch.sqrt(sum((p.grad.float() ** 2).sum()
                                       for p in net.parameters())))
            for name, net in app.nets.items()}


def perturb_cfe(app) -> None:
    """Loads a nonzero CFE output layer (Conv_4's kernel = 0.05·N(0, 1) from
    a numpy seed, as tests/test_torch_training.py does). At its zero init no
    gradient reaches the OP nets, so their first-iteration gradients would
    be 0 on both sides of a comparison."""
    w = app.nets["CFE"].Conv_4.weight
    k = 0.05 * np.random.default_rng(3).normal(size=(3, 3, w.shape[1], w.shape[0]))
    with torch.no_grad():
        w.copy_(torch.tensor(k.transpose(3, 2, 0, 1), dtype=torch.float32))


def _record_conv_shapes(shapes: dict):
    """Wraps the conv's three directions so that each call counts its
    (B, H, W, Cin, Cout) in `shapes[key][direction]`; returns the
    originals."""
    from pde_control_tpu_torch.ops import cuda_conv

    originals = {d: getattr(cuda_conv, f"conv3x3_{d}")
                 for d in ("forward", "dx", "dw")}

    def key_of(d, a, b):
        if d == "dx":  # (dY, wflat)
            return (*a.shape[:3], b.shape[0] // 9, a.shape[3])
        return (*a.shape, b.shape[-1])  # (x, wflat) or (x, dY)

    for d, fn in originals.items():
        short = "fwd" if d == "forward" else d

        def recording(a, b, *rest, _fn=fn, _d=d, _short=short):
            entry = shapes.setdefault(key_of(_d, a, b),
                                      {"fwd": 0, "dx": 0, "dw": 0})
            entry[_short] += 1
            return _fn(a, b, *rest)

        setattr(cuda_conv, f"conv3x3_{d}", recording)
    return originals


def _first_iteration(batch, backend: str, fused: str, conv_impl: str = "xla",
                     shapes: dict | None = None, **app_kw) -> tuple[float, dict]:
    """Loss and gradient norms of one iteration with the CFE perturbed."""
    from pde_control_tpu_torch.ops import cuda_conv

    app = make_app(backend, fused, conv_impl, **app_kw)
    perturb_cfe(app)
    originals = _record_conv_shapes(shapes) if shapes is not None else {}
    try:
        metrics = app.compute_gradients(app.to_batch(batch))
    finally:
        for d, fn in originals.items():
            setattr(cuda_conv, f"conv3x3_{d}", fn)
    return float(metrics["loss"]), _grad_norms(app)


def _compare_first(label: str, got: tuple, ref: tuple) -> None:
    """Loss within 1e-3 relative, each net's gradient norm nonzero on both
    sides and within 2e-2."""
    (loss_k, gn_k), (loss_p, gn_p) = got, ref
    print(f"first iteration loss: {label} {loss_k:.7e} reference {loss_p:.7e}")
    print(f"first iteration grad norms: {label} {gn_k} reference {gn_p}")
    if abs(loss_k - loss_p) > 1e-3 * abs(loss_p):
        raise AssertionError(f"{label}: first-iteration loss differs")
    for name in gn_p:
        if not (gn_k[name] > 0 and gn_p[name] > 0):
            raise AssertionError(f"{label}: {name} gradient norm is not positive")
        if abs(gn_k[name] - gn_p[name]) > 2e-2 * gn_p[name]:
            raise AssertionError(f"{label}: {name} gradient norm differs")


def _record_trips(module, name: str, trips: list):
    """Wraps `module.name` so that each call appends its trip counts."""
    fn = getattr(module, name)

    def recording(*args, **kw):
        out = fn(*args, **kw)
        trips.append(out[-1])
        return out

    setattr(module, name, recording)
    return fn


def _zero_counts() -> None:
    from pde_control_tpu_torch.ops import cuda_cg, cuda_conv, cuda_fluid

    cuda_cg.LAUNCHES = cuda_fluid.LAUNCHES_FWD = cuda_fluid.LAUNCHES_BWD = 0
    cuda_conv.LAUNCHES_FWD = cuda_conv.LAUNCHES_DX = cuda_conv.LAUNCHES_DW = 0


def _counts() -> dict:
    from pde_control_tpu_torch.ops import launch_counts

    return launch_counts()


def conv_launches_per_iteration() -> dict:
    """The conv path's launches per iteration: N CFE calls of
    len(CFE_FEATURES) + 1 convs and one call of each OP net with 5·levels +
    2 eligible convs (two per ConvBlock, levels + 1 + levels blocks, and
    levels upsampling convs; the stride-2 and 1×1 convs stay on cuDNN)
    forward; a dW for each; a dX for each but the top OP's first conv,
    whose input is the ground truth."""
    fwd = N * (len(CFE_FEATURES) + 1) + len(SPANS) * (5 * UNET_LEVELS + 2)
    return {"K4 fwd": fwd, "K4 dX": fwd - 1, "K5": fwd}


def _timed_iterations(app, batch, card: str, label: str, iters: int = 5) -> dict:
    """Times `iters` iterations after the caller's warm-up; returns the
    launches of each kernel in them."""
    before = {k: v.clone() for k, v in app.nets.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    _zero_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        losses.append(app.progress(batch)["loss"])
    end.record()
    torch.cuda.synchronize()
    launches = _counts()
    wall = time.perf_counter() - t0
    ms = start.elapsed_time(end) / iters
    losses = [float(x) for x in losses]
    print(f"{label} losses {losses}")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite loss")
    if all(torch.equal(v, before[k]) for k, v in app.nets.state_dict().items()):
        raise AssertionError("parameters did not change")
    print(f"{label} iteration {ms:.3f} ms (CUDA events; host clock "
          f"{1e3 * wall / iters:.3f} ms), steps/s {N * BATCH / (ms / 1e3):.1f} at "
          f"{H}x{H} n={N} batch={BATCH}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB [{card}]")
    print(f"{label} launches in {iters} iterations: {launches}")
    return launches


def _expect(label: str, launches: dict, per_iter: dict, iters: int = 5) -> None:
    for kernel, n in per_iter.items():
        if launches[kernel] != n * iters:
            raise AssertionError(f"{label}: {kernel} launched {launches[kernel]} "
                                 f"times in {iters} iterations, expected "
                                 f"{n * iters}")


def main_path_phase(card: str, batch: dict, first: dict) -> dict:
    _phase("main path, unfused (K1)")
    from pde_control_tpu_torch.ops import cuda_cg

    _compare_first("K1", first["auto"], first["pcg"])
    app = make_app("auto")
    trips = {"warm": [], "cold": []}
    solve = cuda_cg.pressure_solve

    def recording(*args, **kw):
        p, it = solve(*args, **kw)
        trips["warm" if kw.get("x0") is not None else "cold"].append(it)
        return p, it

    cuda_cg.pressure_solve = recording
    try:
        app.progress(batch)  # first warm-up iteration
    finally:
        cuda_cg.pressure_solve = solve
    trip_means = {k: float(torch.cat(v).float().mean()) for k, v in trips.items()}
    print(f"K1 trip counts per solve in one iteration: warm mean "
          f"{trip_means['warm']:.2f} over {len(trips['warm'])} solves, cold mean "
          f"{trip_means['cold']:.2f} over {len(trips['cold'])} solves")
    app.progress(batch)  # second warm-up iteration
    launches = _timed_iterations(app, batch, card, "unfused")
    # n warm forward solves; the backward runs a cold solve for every step
    # whose pressure reaches the loss: all but the last, whose velocity the
    # final-frame loss never reads.
    print(f"expected per iteration: K1 {N} warm forward + {N - 1} cold backward")
    _expect("unfused", launches, {"K1": 2 * N - 1, "K2": 0, "K3": 0,
                                  "K4 fwd": 0, "K4 dX": 0, "K5": 0})
    return launches


def fused_path_phase(card: str, batch: dict, first: dict) -> dict:
    _phase("main path, fused (K2 / K3)")
    from pde_control_tpu_torch.ops import cuda_fluid

    _compare_first("fused", first["fused"], first["auto"])
    app = make_app("auto", fused="cuda")
    fwd_trips, bwd_trips = [], []
    fwd = _record_trips(cuda_fluid, "fused_step_forward", fwd_trips)
    bwd = _record_trips(cuda_fluid, "fused_step_backward", bwd_trips)
    try:
        app.progress(batch)  # first warm-up iteration
    finally:
        cuda_fluid.fused_step_forward = fwd
        cuda_fluid.fused_step_backward = bwd
    print(f"K2 trip counts per warm solve in one iteration: mean "
          f"{float(torch.cat(fwd_trips).float().mean()):.2f} over {len(fwd_trips)} "
          f"launches; K3 per cold transpose solve: mean "
          f"{float(torch.cat(bwd_trips).float().mean()):.2f} over {len(bwd_trips)} "
          f"launches (last step's: {bwd_trips[0].tolist()})")
    app.progress(batch)  # second warm-up iteration
    launches = _timed_iterations(app, batch, card, "fused")
    # One forward and one backward per step; the last step's backward runs
    # too, because the final-frame loss reads that step's density.
    print(f"expected per iteration: K2 {N}, K3 {N}, K1 0")
    _expect("fused", launches, {"K1": 0, "K2": N, "K3": N, "K4 fwd": 0,
                                "K4 dX": 0, "K5": 0})
    return launches


def conv_path_phase(card: str, batch: dict, first: dict, shapes: dict) -> dict:
    _phase("main path, fused, conv kernels (K2 / K3 / K4 / K5)")
    _compare_first("conv", first["conv"], first["fused"])
    per_iter = conv_launches_per_iteration()
    recorded = {d: sum(v[k] for v in shapes.values())
                for d, k in (("K4 fwd", "fwd"), ("K4 dX", "dx"), ("K5", "dw"))}
    print(f"expected per iteration: K2 {N}, K3 {N}, K1 0, {per_iter}; "
          f"recorded in the first iteration: {recorded} over {len(shapes)} "
          "conv shapes")
    if recorded != per_iter:
        raise AssertionError("the first iteration's convs differ from the count")
    app = make_app("auto", fused="cuda", conv_impl="cuda")
    app.progress(batch)  # warm-up iterations
    app.progress(batch)
    launches = _timed_iterations(app, batch, card, "conv")
    _expect("conv", launches, {"K1": 0, "K2": N, "K3": N, **per_iter})
    return launches


# --------------------------------------------------------------- phase 9

# The refined path: every net trainable, the e2e stages' grad clip 1.0, a
# cosine schedule over 100 updates.
REFINED = dict(sequence_class="refined", grad_clip=1.0, lr_schedule="cosine",
               decay_steps=100)
# (pressure backend, fused, conv_impl) of the three paths.
PATHS = {"unfused": ("auto", "auto", "xla"), "fused": ("auto", "cuda", "xla"),
         "conv": ("auto", "cuda", "cuda")}
K_MULTI = 8


def refined_launches_per_iteration(path: str) -> dict:
    """A 'refined' iteration's launches: n CFE calls of len(CFE_FEATURES) +
    1 convs and n − 1 U-net calls, each on the batch alone, of 5·levels + 2
    eligible convs, forward and dW, and dX for all but the first OP call's
    first conv (fed by data); K2 and K3 once a step; on the unfused path K1
    n times warm forward and n − 1 times cold backward."""
    fwd = N * (len(CFE_FEATURES) + 1) + (N - 1) * (5 * UNET_LEVELS + 2)
    per_iter = dict.fromkeys(("K1", "K2", "K3", "K4 fwd", "K4 dX", "K5"), 0)
    if path == "unfused":
        return {**per_iter, "K1": 2 * N - 1}
    per_iter.update(K2=N, K3=N)
    if path == "conv":
        per_iter.update({"K4 fwd": fwd, "K4 dX": fwd - 1, "K5": fwd})
    return per_iter


def _device_batches(k: int, seed: int) -> dict:
    """`make_batch` for seeds seed … seed + k − 1, stacked on a leading K
    axis, on the card."""
    batches = [make_batch(seed + i) for i in range(k)]
    return {key: torch.tensor(np.stack([b[key] for b in batches]), device="cuda")
            for key in batches[0]}


def _state_diffs(a, b) -> dict:
    """max|d| between two apps' parameters and first and second moments,
    each moment's beside its largest entry, and whether the count and the
    counters are equal."""
    sa, sb = a._state(), b._state()
    n = len(a.trainable)
    out = {"params": max(float((x - y).abs().max()) for x, y in zip(sa[:n], sb[:n]))}
    for name, x, y in (("mu", sa[n], sb[n]), ("nu", sa[n + 1], sb[n + 1])):
        out[name], out[name + "_max"] = (float((x - y).abs().max()),
                                         float(x.abs().max()))
    out["counts_equal"] = all(torch.equal(x, y) for x, y in zip(sa[n + 2:], sb[n + 2:]))
    out["bitwise"] = all(torch.equal(x, y) for x, y in zip(sa, sb))
    return out


def _timed_steps(label: str, app, batches: dict, card: str, graph: bool) -> dict:
    """K_MULTI steps, eager `progress` calls or one `progress_multi` call,
    after the caller's warm-up: CUDA events over the K steps and the host
    clock, steps/s, peak memory and memory reserved (a graph's pool
    included), and the launches: counted by the wrappers for eager steps,
    the captured step's launches times K for replays (a replay runs no
    wrapper)."""
    torch.cuda.synchronize()
    _zero_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    if graph:
        losses = app.progress_multi(batches)["loss"]
    else:
        losses = torch.stack([app.progress({k: v[i] for k, v in batches.items()})
                              ["loss"] for i in range(K_MULTI)])
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = start.elapsed_time(end)
    counted = _counts()
    if graph:
        if any(counted.values()):
            raise AssertionError(f"{label}: a replay ran a wrapper: {counted}")
        counted = {k: K_MULTI * v for k, v in app.graph_launches.items()}
    if not torch.isfinite(losses).all():
        raise AssertionError(f"{label}: non-finite loss {losses.tolist()}")
    steps = N * BATCH * K_MULTI
    print(f"{label}: {K_MULTI} steps {ms:.3f} ms by CUDA events ({ms / K_MULTI:.3f} "
          f"a step), host clock {1e3 * wall:.3f} ms; steps/s {steps / (ms / 1e3):.1f} "
          f"(host clock {steps / wall:.1f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, reserved "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB; launches a step "
          f"{ {k: v // K_MULTI for k, v in counted.items()} } [{card}]")
    return dict(ms=ms / K_MULTI, wall_ms=1e3 * wall / K_MULTI,
                steps_per_s=steps / (ms / 1e3), launches=counted)


def training_phase(card: str, batch: dict) -> dict:
    """The rest of the training step on the card: the refined path's first
    iteration against a reference, one op_supervised step, progress_multi
    against progress calls, the graph's and eager steps' times on the three
    paths, and a non-finite batch inside a replay. Returns each path's
    launches per step under the graph."""
    _phase("training classes and progress_multi")
    print("limits: refined first iteration as the paths' (loss 1e-3 relative, "
          "grad norms nonzero and within 2e-2); progress_multi against "
          "progress calls with cuDNN deterministic: counts and counters equal, "
          "parameters max|d| <= 1e-5 (1% of one step at lr 1e-3), each moment "
          "buffer max|d| <= 1e-2 of its largest entry (bits equal expected: "
          "K2-K5 and cuDNN deterministic)")
    _compare_first("refined conv", _first_iteration(batch, *PATHS["conv"], **REFINED),
                   _first_iteration(batch, *PATHS["unfused"], **REFINED))

    app = make_app(*PATHS["conv"], sequence_class="op_supervised", grad_clip=1.0)
    before = {k: v.clone() for k, v in app.nets.state_dict().items()}
    _zero_counts()
    loss = float(app.progress(batch)["loss"])
    launches = _counts()
    changed = sorted({k.split(".")[0] for k, v in app.nets.state_dict().items()
                      if not torch.equal(v, before[k])})
    print(f"op_supervised conv path, one step: loss {loss:.7e}, nets changed "
          f"{changed}, launches {launches}")
    ops = 5 * UNET_LEVELS + 2
    if not (np.isfinite(loss) and changed == sorted(f"OP{s}" for s in SPANS)):
        raise AssertionError("op_supervised: non-finite loss or wrong nets changed")
    _expect("op_supervised", launches, {
        "K1": 0, "K2": 0, "K3": 0, "K4 fwd": (N - 1) * ops,
        "K4 dX": (N - 1) * (ops - 1), "K5": (N - 1) * ops}, iters=1)
    del app

    batches = _device_batches(K_MULTI, SEED + 10)
    with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                    benchmark=False, allow_tf32=False):
        eager, graph = (make_app(*PATHS["conv"], **REFINED) for _ in range(2))
        for app in (eager, graph):
            perturb_cfe(app)
        for i in range(K_MULTI):
            eager.progress({k: v[i] for k, v in batches.items()})
        graph.progress_multi(batches)
    d = _state_diffs(eager, graph)
    print(f"progress_multi({K_MULTI}) against {K_MULTI} progress calls, refined conv "
          f"path: {d}")
    if not (d["counts_equal"] and d["params"] <= 1e-5
            and d["mu"] <= 1e-2 * d["mu_max"] and d["nu"] <= 1e-2 * d["nu_max"]):
        raise AssertionError("progress_multi differs from progress calls")
    del eager, graph
    torch.cuda.empty_cache()

    per_step = {}
    for path, config in PATHS.items():
        app = make_app(*config, **REFINED)
        app.progress({k: v[0] for k, v in batches.items()})  # warm-up steps
        app.progress({k: v[1] for k, v in batches.items()})
        torch.cuda.reset_peak_memory_stats()
        eager = _timed_steps(f"refined {path} eager", app, batches, card, False)
        _expect(f"refined {path} eager", eager["launches"],
                refined_launches_per_iteration(path), iters=K_MULTI)
        del app
        torch.cuda.empty_cache()
        app = make_app(*config, **REFINED)
        torch.cuda.reset_peak_memory_stats()
        app.progress_multi(batches)  # warm-up, capture and K replays
        graph = _timed_steps(f"refined {path} graph", app, batches, card, True)
        _expect(f"refined {path} graph", graph["launches"],
                refined_launches_per_iteration(path), iters=K_MULTI)
        print(f"refined {path}: graph {graph['ms']:.3f} ms a step against eager "
              f"{eager['ms']:.3f} ({eager['ms'] / graph['ms']:.2f}x) by CUDA "
              f"events [{card}]")
        per_step[path] = app.graph_launches
        if path == "conv":
            state = [t.clone() for t in app._state()]
            bad = _device_batches(1, SEED + 20)
            bad["obs"][0, 1, -1, H // 2, H // 3, 0] = float("nan")
            m = app.progress_multi(bad)
            kept = all(torch.equal(a, b) for a, b in
                       zip(app._state()[:-2], state[:-2]))
            print(f"a NaN batch in one replay: loss {float(m['loss'][0])}, "
                  f"counters {int(m['notfinite_total'][0])} total "
                  f"{int(m['notfinite_consec'][0])} consecutive (before: "
                  f"{int(state[-2])}, {int(state[-1])}), parameters, moments "
                  f"and count kept: {kept}")
            if not (kept and int(app.notfinite_total) == int(state[-2]) + 1
                    and int(app.notfinite_consec) == int(state[-1]) + 1):
                raise AssertionError("the non-finite replay was not skipped")
        del app
        torch.cuda.empty_cache()
    return per_step


# BASELINE config 4 (indirect smoke control) at full width: 64², n=16,
# batch 8, CFE 48-96-96-48 with the inflow channel, OP U-nets of base
# width 16 and 3 levels (spans 16/8/4/2), pressure maxiter 200, the
# obstacle course of `default_obstacles`. Cut in counts only.
CONFIG4 = dict(size=64, n=16, batch=8, num_train=64, num_val=16,
               iterations=16, steps_per_call=8, autosave_every=8)
CONFIG4_WORKDIR = "runs/chip_smoke_config4"


def _config4_recorder(stages: list):
    """A `ControlTraining` that records, for each stage it trains: each
    `progress_multi` call's device time (CUDA events) and the launches the
    wrappers counted in it, the captured step's launches, the stage's peak
    and reserved memory, and its trained parameters."""
    from pde_control_tpu_torch.control.training import (
        GRAPH_WARMUP_STEPS,
        ControlTraining,
    )

    class Recorded(ControlTraining):
        def train(self, iterations, **kw):
            torch.cuda.synchronize()
            rec = {"stage": ",".join(self.trainable_networks),
                   "class": self.sequence_class, "calls": [],
                   "reserved_before": torch.cuda.memory_reserved()}
            stages.append(rec)
            self._rec = rec
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = super().train(iterations, **kw)
            torch.cuda.synchronize()
            rec.update(seconds=time.perf_counter() - t0, result=out,
                       graph_launches=dict(self.graph_launches),
                       steps=self.step_count,
                       peak=torch.cuda.max_memory_allocated(),
                       reserved=torch.cuda.memory_reserved(),
                       params={name: {k: v.detach().cpu().clone()
                                      for k, v in net.state_dict().items()}
                               for name, net in self.nets.items()})
            return out

        def progress_multi(self, batches):
            captured = bool(self._graphs)
            before = _counts()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = super().progress_multi(batches)
            end.record()
            torch.cuda.synchronize()
            after = _counts()
            counted = {k: after[k] - before[k] for k in after}
            k = int(next(iter(out.values())).shape[0])
            if captured:
                expect = dict.fromkeys(counted, 0)  # a replay runs no wrapper
            else:  # the warm-up steps and the capture
                expect = {name: (GRAPH_WARMUP_STEPS + 1)
                          * self.graph_launches[name] for name in counted}
            if counted != expect:
                raise AssertionError(
                    f"{self._rec['stage']}: the wrappers counted {counted} in a "
                    f"progress_multi call, expected {expect}")
            self._rec["calls"].append({"k": k, "ms": start.elapsed_time(end),
                                       "replay_only": captured})
            return out

    return Recorded


def config4_phase(card: str) -> dict:
    """BASELINE config 4 (`CONFIG4`) through the port's entry points: the
    datasets generated on the default route (K1), a first CFE-stage
    iteration on the conv route against the default route, `run_curriculum`
    on K2–K5 (`fused='cuda', conv_impl='cuda'`), `run_curriculum(resume=
    True)` on the same workdir (every stage skipped, the same eval block bit
    for bit), and one saved `CFE.msgpack` read back. Returns the launches
    the wrappers counted in the phase, by kernel."""
    _phase("config 4 (indirect smoke control) through run_curriculum")
    import shutil
    from pathlib import Path

    from pde_control_tpu_torch import ControlTraining, IncompressibleFluidPDE
    from pde_control_tpu_torch.experiments import curriculum, fluid2d
    from pde_control_tpu_torch.utils.checkpoint import load_network

    c = CONFIG4
    workdir = Path(__file__).resolve().parent / CONFIG4_WORKDIR
    shutil.rmtree(workdir, ignore_errors=True)
    datadir = str(workdir / "data")
    phase_counts = dict.fromkeys(_counts(), 0)

    def add_counts():
        for k, v in _counts().items():
            phase_counts[k] += v

    def setup():
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fluid2d._smoke_indirect_setup(
            c["size"], c["n"], c["num_train"], c["num_val"], 1.0, datadir,
            device="cuda", fused="cuda", conv_impl="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _counts()
        add_counts()
        return out, seconds, launches

    (pde, train, val), seconds, launches = setup()
    rollouts = -(-c["num_train"] // 8) + -(-c["num_val"] // 8)
    print(f"data: {c['num_train']} + {c['num_val']} trajectories of "
          f"{c['n'] + 1} frames at {c['size']}^2 ({rollouts} rollouts of 8 warm-up"
          f" + {c['n']} steps, unfused, pressure on K1) in {seconds:.2f} s, "
          f"{launches['K1']} K1 launches; written to the disk cache [{card}]")
    if launches["K1"] != rollouts * (8 + c["n"]):
        raise AssertionError(f"data generation: {launches['K1']} K1 launches, "
                             f"expected {rollouts * (8 + c['n'])}")
    if not (np.isfinite(train.obs).all() and train.obs.shape == (
            c["num_train"], c["n"] + 1, c["size"], c["size"], 1)):
        raise AssertionError("data generation: non-finite or misshapen obs")

    # The first CFE-stage iteration, conv route against the default route.
    batch = train.take(np.arange(c["batch"]))
    default_pde = IncompressibleFluidPDE(
        pde.domain, dataclasses.replace(pde.cfg, fused="auto"),
        control="buoyancy", with_inflow=True, unet_levels=pde.unet_levels,
        cfe_features=pde.cfe_features, op_base_features=pde.op_base_features)
    first, weights = {}, None
    for label, p in (("conv", pde), ("default", default_pde)):
        app = ControlTraining(c["n"], p, trainable_networks=("CFE",),
                              sequence_class="chain",
                              obs_loss_frames=tuple(range(1, c["n"] + 1)),
                              seed=0).prepare()
        if weights is None:
            perturb_cfe(app)
            weights = {"CFE": {k: v.clone() for k, v in
                               app.nets["CFE"].state_dict().items()}}
        app.load_params(weights)
        _zero_counts()
        metrics = app.compute_gradients(app.to_batch(batch))
        add_counts()
        first[label] = (float(metrics["loss"]), _grad_norms(app))
        del app
    _compare_first("config 4 CFE stage, conv route (K2-K5) against K1 + cuDNN",
                   first["conv"], first["default"])

    ccfg = curriculum.CurriculumConfig(
        n=c["n"], batch_size=c["batch"], cfe_iterations=c["iterations"],
        op_iterations=c["iterations"], e2e_iterations=c["iterations"],
        cfe_lr=1e-3, op_lr=1e-3, e2e_lr=1e-4, grad_clip=1.0, force_reg=3e-5,
        seed=0, steps_per_call=c["steps_per_call"],
        autosave_every=c["autosave_every"])
    stages: list = []
    original = curriculum.ControlTraining
    curriculum.ControlTraining = _config4_recorder(stages)
    try:
        _zero_counts()
        t0 = time.perf_counter()
        results = curriculum.run_curriculum(pde, ccfg, train, val, str(workdir))
        seconds = time.perf_counter() - t0
        add_counts()
        print(f"run_curriculum: {len(stages)} stages in {seconds:.2f} s; "
              f"wrappers counted {_counts()} (data generation not included; "
              f"captures, warm-up steps, renders and the eval) [{card}]")
        (pde2, train2, val2), seconds2, launches2 = setup()
        if launches2["K1"] != 0 or not np.array_equal(train2.obs, train.obs):
            raise AssertionError("the disk cache missed or changed the data")
        print(f"data again from the disk cache in {seconds2:.2f} s, 0 K1 launches")
        n_stages = len(stages)
        _zero_counts()
        resumed = curriculum.run_curriculum(pde2, ccfg, train2, val2,
                                            str(workdir), resume=True)
        add_counts()
    finally:
        curriculum.ControlTraining = original

    names = ["cfe_supervised"] + [f"op{s}_supervised" for s in
                                  sorted(curriculum.op_spans(c["n"]))] + [
        f"end_to_end_n{c['n']}"]
    if len(stages) != n_stages or n_stages != len(names):
        raise AssertionError(f"stages trained: {n_stages}, then "
                             f"{len(stages) - n_stages} on resume")
    pool = 0
    for name, rec in zip(names, stages):
        res = rec["result"]
        bad = [k for k, v in res.items() if not np.isfinite(v)]
        if bad or res.get("iterations_run") != c["iterations"]:
            raise AssertionError(f"{name}: non-finite {bad} or iterations {res}")
        replays = [cl for cl in rec["calls"] if cl["replay_only"]]
        if not replays or len(rec["calls"]) != c["iterations"] // c[
                "steps_per_call"]:
            raise AssertionError(f"{name}: calls {rec['calls']}")
        ms = sum(cl["ms"] for cl in replays) / sum(cl["k"] for cl in replays)
        gl = rec["graph_launches"]
        physics = rec["class"] != "op_supervised"
        need = ["K4 fwd", "K4 dX", "K5"] + (["K2", "K3"] if physics else [])
        if any(gl[k] <= 0 for k in need) or gl["K1"] != 0 or (
                not physics and gl["K2"] + gl["K3"] != 0):
            raise AssertionError(f"{name}: launches a replay {gl}")
        rec["ms"] = ms
        pool = max(pool, rec["reserved"] - rec["reserved_before"])
        print(f"stage {name} ({rec['class']}, trains {rec['stage']}): "
              f"{rec['steps']} steps in {rec['seconds']:.2f} s (capture "
              f"included); under the graph {ms:.3f} ms a step, "
              f"{c['n'] * c['batch'] / (ms / 1e3):.1f} steps/s (n x batch a "
              f"second); launches a replay {gl}, x {rec['steps']} steps = "
              f"{ {k: v * rec['steps'] for k, v in gl.items()} }; peak "
              f"{rec['peak'] / 2**20:.1f} MiB, reserved "
              f"{rec['reserved_before'] / 2**20:.1f} -> "
              f"{rec['reserved'] / 2**20:.1f} MiB; loss "
              f"{res['loss']:.6e} [{card}]")
    base = stages[0]["reserved_before"]
    for name, rec in zip(names, stages):
        if rec["reserved_before"] > base + pool:
            raise AssertionError(
                f"{name}: {rec['reserved_before'] / 2**20:.1f} MiB reserved "
                f"before the stage, more than the first stage's "
                f"{base / 2**20:.1f} plus one stage's pool {pool / 2**20:.1f}")

    ev = results["eval"]
    with open(workdir / "results.json") as f:
        on_disk = json.load(f)
    if on_disk.get("eval") != json.loads(json.dumps(ev)) or not all(
            np.all(np.isfinite(v)) for v in ev.values()):
        raise AssertionError(f"eval block missing or non-finite: {ev}")
    print("eval: " + json.dumps({k: v for k, v in ev.items()
                                 if not isinstance(v, list)}))
    for name in names:
        if resumed[name] != {"resumed": True}:
            raise AssertionError(f"resume: {name} gave {resumed[name]}")
    if resumed["eval"] != ev:
        raise AssertionError(f"resume: the eval block differs: "
                             f"{resumed['eval']} against {ev}")
    print("resume: every stage skipped, the eval block the same bit for bit")

    saved = load_network(str(workdir / "ckpt_cfe" / "CFE.msgpack"))
    trained = stages[0]["params"]["CFE"]
    if set(saved) != set(trained) or not all(
            torch.equal(saved[k], trained[k]) for k in trained):
        raise AssertionError("ckpt_cfe/CFE.msgpack is not the trained CFE")
    print(f"ckpt_cfe/CFE.msgpack read back by load_network: the CFE stage's "
          f"{len(trained)} tensors bit for bit; the phase's wrapper counts "
          f"{phase_counts}")
    return {"counted": phase_counts,
            "graph": {k: sum(r["graph_launches"][k] * r["steps"]
                             for r in stages[:n_stages])
                      for k in phase_counts}}


def main() -> None:
    card = device_phase()
    build_phase()
    k1 = kernel_phase(card)
    fused = fused_kernel_phase(card)
    batch = make_batch()
    _phase("first iterations, CFE perturbed")
    shapes = {}
    first = {"pcg": _first_iteration(batch, "pcg", "auto"),
             "auto": _first_iteration(batch, "auto", "auto"),
             "fused": _first_iteration(batch, "auto", "cuda"),
             "conv": _first_iteration(batch, "auto", "cuda", "cuda", shapes)}
    unfused_launches = main_path_phase(card, batch, first)
    fused_launches = fused_path_phase(card, batch, first)
    conv_launches = conv_path_phase(card, batch, first, shapes)
    training_phase(card, batch)
    config4 = config4_phase(card)
    # Last, so that its CUDA graphs' memory stays out of the paths' peaks.
    conv = conv_kernel_phase(card, shapes)

    def entry(name, source, replaces, launches, s, keys):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": s["err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": s["bound_by"], "library_ms": s.get("library_ms"),
                **{k: s[k] for k in ("graph_ms", "plan") if k in s},
                "config4_launches": sum(config4["counted"][k] for k in keys),
                "config4_graph_launches": sum(config4["graph"][k] for k in keys)}

    k1_summary = {key: float(np.mean([s[key] for s in k1.values()]))
                  for key in ("ms", "plain_ms", "bound_ms")}
    k1_summary.update(err=max(s["err"] for s in k1.values()),
                      bound_by=k1["warm"]["bound_by"], plan=k1["cold"]["plan"])
    kernels = [
        entry("pcg_pressure_solve", "pde_control_tpu_torch/csrc/pcg.cu",
              "pde_control_tpu/ops/pallas_cg.py:180", unfused_launches["K1"],
              k1_summary, ("K1",)),
        entry("fused_step_forward", "pde_control_tpu_torch/csrc/fused_step.cu",
              "pde_control_tpu/ops/pallas_fluid.py:482", fused_launches["K2"],
              fused["fwd"], ("K2",)),
        entry("fused_step_backward", "pde_control_tpu_torch/csrc/fused_step.cu",
              "pde_control_tpu/ops/pallas_fluid.py:516", fused_launches["K3"],
              fused["bwd"], ("K3",)),
        entry("conv3x3_forward_and_dx", "pde_control_tpu_torch/csrc/conv3x3.cu",
              "pde_control_tpu/ops/pallas_conv.py:110",
              conv_launches["K4 fwd"] + conv_launches["K4 dX"], conv["K4"],
              ("K4 fwd", "K4 dX")),
        entry("conv3x3_dw", "pde_control_tpu_torch/csrc/conv3x3.cu",
              "pde_control_tpu/ops/pallas_conv.py:160", conv_launches["K5"],
              conv["K5"], ("K5",)),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
