"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):
  1. device: needs CUDA; prints the card, its power limit and the TF32
     settings (both off);
  2. build: compiles the CUDA kernels from `pde_control_tpu_torch/csrc`
     (one nvcc per source, in parallel), prints each kernel's registers and
     spills (a kernel the report does not know, a K1, K3, K4 or K5 kernel
     missing from it or one that spills fails), checks the kernels'
     shared-memory counts, K3's banded scratch and K1's, K2's and K3's
     layouts (the large one at 112² and 128², K2's from 109²; the banded
     one from 154² for K1, from 146² and 152² for K2 and K3) against the
     Python gates and plans, and prints K3's plan at 64²×8 and ×64, K1's,
     K2's and K3's at 128²×8 and K1's at 256²×8 and 351²×8;
  3. the pressure solve (K1) against its plain torch version on the card:
     64² (bench plate, closed), 32² (open, with an obstacle), 48², 96² and
     128² (closed; 128² in the large layout), batch 8, warm and cold, at
     tol 1e-4 / 100 iterations and tol 1e-6 / 500, under `solve_plan`'s
     plan and every plan its launcher takes; residuals, solution error,
     trip counts, the gradient through `solve_pressure` against the plain
     path; against the JAX package's goldens (`tests/goldens/pcg_32.npz`,
     and `pcg_128.npz` with trip counts within 1); times at 64²×8 and ×64,
     tol 1e-4 / 100, and at 128²×8 (tol 1e-4 / 200, smoke_128's) under
     every plan beside plain and the bound, and the plans;
  4. the fused step's forward (K2) and backward (K3) against their plain
     versions: 64², 32², 32×48, 24×30, 8×8, 96², 110², 112², 127², 128²
     and 64×128 (from 112² in the cluster core's large layout, its bands
     of unequal rows at 127²; at 110² K2 large and K3 small), closed with
     the plate, batch 8, cold and warm, with force, with inflow, at zero
     velocity (the tie points), and with a NaN and an infinity planted in
     the velocity (the non-finite cells must be the plain version's), at
     tol 1e-6 / 500, each under its plan (`fwd_plan`, `bwd_plan`) and under
     every plan its launcher takes, each twice for the same bits; both
     against the JAX package's goldens (`tests/goldens/fused_step_32.npz`
     and `fused_step_128.npz`, the latter's trip counts within 3); then
     their times at 64²×8, tol 1e-4 / 100, at maxiter 0 (the rest without
     the CG trips) and at batch 64, and their plans; and at 128²×8 (warm,
     force, tol 1e-4 / maxiter 200, smoke_128's step) beside plain, the
     bound, the plan and the layout;
  5. the first iteration of each training path below, every one with the
     same perturbed CFE output layer, so that every net has a gradient; the
     conv path's run records the shape of every conv its kernels compute;
  6. the main path, unfused: the 64² smoke-control training iteration
     (n=16, batch 8, full widths, bf16 nets) with the pressure solve on K1;
     the first iteration against the plain solve, then against the JAX
     package's (`tests/goldens/main_path_64.npz`, written on the CPU by
     `scripts/make_main_path_golden.py`; its weights drawn again here and
     held to its digest, loaded through `params_from_flax`): with fp32
     nets the loss within 1e-3 relative, each net's gradient norm within
     2e-2 and its gradient's projections on 16 ±1 directions within 1e-4
     of its norm beyond twice the JAX package's own spread
     (`tests/goldens/main_path_64_grads.npz`), with bf16 nets the loss
     within 1e-3 and, per net and kind of leaf, the distance of the bf16
     gradient from the fp32 one within 1.25 × the JAX package's own +
     1e-3 (`golden_check`), trip means beside the JAX CG's; 2 warm-up and
     5 timed iterations, K1's launches;
  7. the main path, fused (`FluidConfig.fused='cuda'`): the same
     iteration with each step on K2 and K3; the first iteration against
     the unfused one and against the JAX golden as in 6, 2 warm-up and 5
     timed iterations, K2's and K3's launches;
  8. the main path, fused, with the nets' 3×3 stride-1 convs on K4/K5
     (`conv_impl='cuda'`): the first iteration against the fused cuDNN
     path and, bf16 alone (K4/K5 take no fp32), against the JAX golden as
     in 6, its bf16 gradient's distance taken from the unfused path's fp32
     one, 2 warm-up and 5 timed iterations, the launches of all five
     kernels; then "128², fused (K2 / K3)": `profile_bench.make_app(128,
     16, 8, maxiter=200)` with `fused='cuda'` against the same app unfused
     (K1), the first iteration of both (CFE perturbed; loss 1e-3 relative,
     grad norms within 2e-2), 16 K2 + 16 K3 + 0 K1 an iteration, eager
     iterations, and `progress_multi`'s graph for 'staggered' and 'chain'
     on both apps (ms a step, peak and reserved memory, capture seconds,
     graph nodes; `python3 chip_smoke.py fused128` runs phases 2, 4 and
     this one alone and prints no result); then "K1 beyond 128² (banded
     layout)": K1 against its plain version under every plan at 129² and
     153² (the large layout), 154², 192², 256², 257², 288², 289², 351²,
     362², 96×320 and 320×96 (the banded one) and 8×1000 (large, an open
     box), batch
     8, cold and warm, tol 1e-4 / 200 and 1e-5 / 500; the gradient through
     `solve_pressure` at 256²; against `tests/goldens/pcg_256.npz` and
     `pcg_edges.npz` (351² warm, 362² cold) and, on a closed 64×600 box
     where the 4× rule stops a sample's solve after a few trips in the
     JAX package's kernel too, `pcg_closed.npz` (each converged sample
     within 1e-4 of its max|p|, trips within 3 or 10% of its best
     iterate's; the stopped one converged, or stopped no worse); its times at 256²×8 and
     351²×8 under every plan beside plain, the 'pcg' route and the bound;
     the 256² indirect-smoke app (`APP256`: the task's obstacles, inflow
     and nets) on K1 against the 'pcg' route, first iteration (31 K1) and
     `progress_multi`'s graph both ways; and `run_smoke_indirect(size=
     256)` cut as `ENTRIES` cuts smoke_128 (`python3 chip_smoke.py k1big`
     runs phase 2 and this one alone and prints its row of the kernels'
     line, no result); then "K2/K3 beyond 128² (banded)": K2 and K3
     against their plain versions under every plan at 129² (large),
     153², 154², 192², 224², 225², 227², 236² (the Pallas fluid gate's
     square edge), 96×320, 320×96 and, in open boxes, the gate's edges
     64×600 (banded), 8×990 (K2 large, K3 banded) and 430×8 (large),
     batch 8, in phase 4's cases, tol 1e-6 / 500, trip counts within 3
     or 10%; against `tests/goldens/fused_step_big.npz` (236² and
     64×625); their times at 145², 146², 151² and 152² (each kernel's
     last large and first banded grid), 192² and 236², batch 8 (warm,
     force, tol 1e-4 / 200), beside plain and the bound, split into the
     trips and the rest (maxiter 0); and the 232² app (`profile_bench.make_app(232, 16, 8,
     maxiter=200)`, the largest square of the gate its U-nets take) fused
     against unfused (K1, banded), first iteration (16 K2 + 16 K3 against
     31 K1) and the 'staggered' graph both ways (`python3 chip_smoke.py
     fusedbig` runs phase 2 and this one alone and prints its rows of the
     kernels' line, no result);
  9. the rest of the training step, on the 'refined' class (every net
     trainable, grad clip 1.0, cosine over 100 updates): its first
     iteration on the conv path against K1 with cuDNN; one op_supervised
     step on the conv path; `progress_multi` (K = 4 replays of one CUDA
     graph of the step) against 4 `progress` calls from the same state;
     both timed on the three paths (CUDA events and the host clock over
     the K steps, steps/s, peak memory, launches a step: counted by the
     wrappers for eager steps, the captured step's times K for replays);
     a NaN batch inside a replay, skipped;
 10. BASELINE configs 4, 3 and 5 (`CONFIGS`: indirect smoke control,
     shape transition, natural flow at n=128) through `run_curriculum` at
     full width, each: its data generated on K1 into a disk cache, the CFE
     stage's first iteration on K2-K5 against K1 + cuDNN, every stage on
     K2-K5 under its graph (ms a step, launches a replay, warm-up and
     capture seconds, peak and reserved memory, each mid-stage autosave
     read back bit for bit), the eval block, a resumed run with the same
     eval bits, the CFE checkpoint read back; then the refined class at
     n=128 as one captured step; then the rest of the 2D module surface
     (`OOD`): `generalize_shapes` from config 3's ckpt_final and
     `generalize_smoke` from config 4's (every row, `results.json` with the
     JAX module's keys, K1's launches as many as the rows' rollouts take),
     `render_rollout.render('smoke_indirect')` on config 4's run (four
     PNGs), config 4's data cache through the native gather against numpy
     (the same bits, both times), one 64² step with
     `advection_mode='gather'` on the card against the CPU (state, loss,
     gradients), the CFE at 64² x 8 under `conv_impl` 'patches', 'shifted'
     and 'im2col' against cuDNN (2e-2, times beside cuDNN's), and
     `profile_bench`'s phases; the CLI's `run shape_transition` on the
     card's default route; last the 128² and 3D entries (`ENTRIES`):
     `run smoke_128` (its data generated on K1 into a disk cache first,
     every stage unfused on K1 and cuDNN under its graph), `run smoke3d`
     (24³, the exact 3D spectral solve, no K1-K5) and `run
     smoke3d_indirect` (32³ with the plate: the 3D CG, eager in the data
     and the evals, all maxiter trips under each stage's graph; first the
     captured solve against eager, forward warm and backward cold, the
     same bits, then each physics stage's CG trips read from the card
     after the last replay and the CG's share of a step; no K1-K5), each
     then its `_ft` from the run's ckpt_final: data seconds and launches,
     each stage's ms a step under its graph, capture and instantiate
     seconds and graph nodes, launches a replay, peak and reserved memory,
     the eval block beside zero force;
 11. BASELINE configs 1 and 2 (`BURGERS`: 1D Burgers, N=32, n=32, batch
     32, 1024 + 128 trajectories, fp32 nets with TF32 off) through the
     entry points (`run_chain_supervised`, `run_hierarchical`): the data
     generated on the card, the first CFE-stage iteration on the card
     against the CPU at fp32 tolerance (CFE output layer perturbed), every
     stage under its graph (ms a step under the graph and eager, device
     operations and busy share of a replay, and of an eager step in the
     CFE and e2e stages, by `torch.profiler`, peak memory), the eval
     blocks; no K1-K5 launch;
 12. the adjoint (`ADJOINT`): `optimize_forces` on Burgers and on
     compare_smoke's 64², n=16 task (32 trajectories generated on K1),
     each as one captured optimizer step replayed (ms a step, launches a
     replay: 2n - 1 K1 unfused, n K2 + n K3 with `fused='cuda'`) against
     eager, the first iterations' histories agreeing, and the two smoke
     routes' first iterations agreeing; then `compare_burgers` and
     `compare_smoke` with cut counts, each writing comparison.json with
     all five rows (`python3 chip_smoke.py burgers` runs 11 and 12 alone
     and prints no result);
 13. data parallelism and the spatial split (`parallel/`) on one card:
     "mesh", `ControlTraining(mesh=make_mesh(1))` in a world of one NCCL
     rank (a FileStore in a temporary directory) against `mesh=None`, the
     same bits: the first iteration on the unfused, fused and conv paths,
     then K_MESH `progress_multi` steps of the main path under the graph
     (ms a step, graph nodes, the all-reduces captured, NCCL kernel
     nodes, 31 K1 a replay); "spatial", `spatial_fluid_step` on a (1, 1)
     mesh at 64² with the plate, batch 8, in each mode ('spectral'
     without the plate) against the dense step, forward and gradients
     (the JAX package's tolerances), the divergence after projection and
     ms a forward step beside the dense one's, then
     `optimize_forces_spatial` (64², n=3, 25 iterations, 'pcg', cosine)
     improving at least 2×, no K1-K5 launch; two gloo ranks on the card
     as subprocesses (`chip_smoke.py gloo-rank`), after a probe that gloo
     takes CUDA tensors, two eager steps against `mesh=None` on the whole
     batch (`GLOO_DTYPE`), and `progress_multi` refused; `torchrun
     --nproc-per-node 1 -m pde_control_tpu_torch.experiments.run
     smoke_indirect --mesh 1` with the CLI phase's counts. Between
     "spatial" and the gloo ranks, "spatial3d": `spatial_fluid3d_step` on
     a (1, 1) mesh at the 3D tasks' sizes (`SPATIAL3D_CASES`: smoke3d's
     24³ box, batch 4, 'spectral' and 'auto'; smoke3d_indirect's 32³
     plate, batch 8, the task's inflow, a full-field then a per-batch
     buoyancy factor, a warm-started pressure, 'pcg' and 'jax') against
     the dense `fluid3d_step`, forward and gradients of the force and the
     factor (the JAX package's tolerances and `SPATIAL3D_GRAD_L2`), with
     max|div|, ms a forward step and the peak memory of rollout + backward
     beside the dense step's; `spatial_pressure_solve3d_diag` on the
     plate ('pcg' trips × 3 ≤ 'jax' trips, residuals ≤ 10 × tol); and
     scripts/spatial3d_memory.py's program (128³, n = 4, split and dense:
     peak memory, ms, the loss) (`python3 chip_smoke.py mesh` runs 13
     alone and prints no result);
 14. the 3×3 conv's forward and dX (K4) and dW (K5) against the JAX
     package's goldens (`tests/goldens/conv3x3_32.npz`) under every plan
     their launchers take, at the conv shapes of configs 3-5 that the
     main path does not reach under every plan, and against their plain
     versions at every conv shape the conv path ran, with db, then their
     device times (CUDA-graph replay) beside the plain versions', cuDNN's
     and the bound, per launch and summed over one iteration; K5's bound
     also with the bytes of its fp32 partials; y, dX and dW the same bits
     in two calls; each shape's K4 and K5 plans. Then K4 alone at the
     shapes its tiles, segments and splits could get wrong, checked but not
     timed, and K5 alone at the shapes its runs of whole rows could get
     wrong, checked and timed; neither is summed. It runs last because the
     graphs' memory pools would raise the paths' peak memory.
Each phase's seconds follow it. The line before the last is the kernels'
JSON summary (with each kernel's launches in configs 3-5, in the OOD evals,
in the 128² and 3D entries, in the 128² fused app and in the mesh,
spatial and spatial3d phases, and K1's, K2's and K3's times at 128²x8;
K1's banded layout in a row of its own, `pcg_pressure_solve_banded`, and
K2's and K3's in two, `fused_step_forward_banded` and
`fused_step_backward_banded`);
the last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
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
# K3's instantiations <threads, trip profile, layout (0 small, 1 large, 2
# banded)>: the main path's in the small layout, the one `fused_bwd_trace`
# selects, the main path's in the large layout (grids from 112²) and in the
# banded one (from 152², the window phase in global memory); K1's <threads,
# large layout> (the large one from 112²) and its banded kernel <threads>
# (from 154²), and K2's <threads, layout> (large from 109², banded from
# 146²). Each must stand in ptxas's report, without spills.
K3_KERNELS = {"fused_bwd_kernel<512, 0, 0>", "fused_bwd_kernel<512, 1, 0>",
              "fused_bwd_kernel<512, 0, 1>", "fused_bwd_kernel<512, 0, 2>"}
K1_K2_KERNELS = {"pcg_cluster_kernel<512, 0>", "pcg_cluster_kernel<512, 1>",
                 "pcg_banded_kernel<512>", "fused_fwd_kernel<512, 0>",
                 "fused_fwd_kernel<512, 1>", "fused_fwd_kernel<512, 2>"}
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


_PHASES: list = []  # (name, start on the host clock) of each phase begun


def _phase(name: str | None) -> None:
    """Starts the phase `name` (None: the end of the last one), printing
    the seconds of the one before it."""
    now = time.perf_counter()
    if _PHASES:
        prev, t0 = _PHASES[-1]
        print(f"-- {prev}: {now - t0:.1f} s (script so far "
              f"{now - _PHASES[0][1]:.1f} s)", flush=True)
    if name is not None:
        _PHASES.append((name, now))
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
        name = re.search(r"((?:pcg_cluster|pcg_banded|fused_fwd|fused_bwd|"
                         r"conv3x3_fwd_reduce|"
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
    shapes = ((H, H), (32, 32), (48, 48), (96, 96), (112, 112), (128, 128),
              (32, 48), (24, 30), (8, 8), (64, 128))
    for name, c_name, plans, plan, query, more in (
            ("K1", "pcg_shared_bytes", cuda_cg.solve_plans, cuda_cg.solve_plan,
             cuda_cg._kernel()[1], ()),
            ("K2", "fused_fwd_shared_bytes", cuda_fluid.fwd_plans,
             cuda_fluid.fwd_plan, cuda_fluid._kernels()[3],
             tuple(FUSED_BANDED_SHAPES))):
        fn = getattr(lib, c_name)
        fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_size_t
        cases = [(h, w, p) for h, w in shapes + more for p in plans(h, w)]
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
    # K1's layouts: each exactly where the Python count says so, and its
    # byte counts beyond 128² (the large and banded layouts).
    fn = lib.pcg_layout
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    k1_shapes = shapes + tuple(K1_BANDED_SHAPES)
    for h, w in k1_shapes:
        want = cuda_cg.layout(h, w)
        if fn(h, w, cuda_cg.CLUSTER_THREADS) != want:
            raise AssertionError(f"pcg_layout({h}, {w}) = "
                                 f"{fn(h, w, cuda_cg.CLUSTER_THREADS)}, "
                                 f"cuda_cg.layout says {want}")
    bytes_fn = lib.pcg_shared_bytes
    cases = [(h, w, p) for h, w in k1_shapes[len(shapes):]
             for p in cuda_cg.solve_plans(h, w)]
    for h, w, p in cases:
        if bytes_fn(h, w, p.cluster, p.threads) != p.shared_bytes:
            raise AssertionError(f"pcg_shared_bytes({h}, {w}, {p.cluster}): "
                                 f"{bytes_fn(h, w, p.cluster, p.threads)}, the "
                                 f"plan counts {p.shared_bytes}")
    print(f"pcg_shared_bytes equal to the plan's count at {len(cases)} more "
          "cases beyond 128²")
    for kind in (cuda_cg.LARGE, cuda_cg.BANDED):
        print(f"K1 {cuda_cg.LAYOUT_NAMES[kind]} layout at " + ", ".join(
            f"{h}x{w}" for h, w in k1_shapes if cuda_cg.layout(h, w) == kind)
              + " (the kernel's and the Python count agree)")
    for n in (K1_BIG, K1_BANDED_TIMED[0], K1_BANDED_TIMED[1]):
        print(f"K1 plan at {n}x{n}x{BATCH}: "
              f"{_plan_text(cuda_cg.solve_plan(BATCH, n, n))}; resident "
              "clusters: " + ", ".join(
                  f"C={p.cluster}: {cuda_cg._kernel()[1](n, n, p.cluster, p.threads)}"
                  for p in cuda_cg.solve_plans(n, n)))
    # K2's and K3's layouts: each exactly where the Python counts say so
    # (K2 large from 109² and banded from 146², K3 from 112² and 152²), and
    # each kernel's plan and resident clusters at 128²×8.
    k = FUSED_STEP["max_shift"]
    fwd_layout, bwd_layout = lib.fused_fwd_layout, lib.fused_bwd_layout
    fwd_layout.argtypes, fwd_layout.restype = [ctypes.c_int] * 3, ctypes.c_int
    bwd_layout.argtypes, bwd_layout.restype = [ctypes.c_int] * 4, ctypes.c_int
    layout_shapes = (shapes + ((104, 104), (108, 108), (109, 109), (111, 111),
                               (145, 145), (146, 146), (151, 151))
                     + tuple(FUSED_BANDED_SHAPES))
    for h, w in layout_shapes:
        want = (cuda_fluid.fwd_layout(h, w), cuda_fluid.bwd_layout(h, w, k))
        got = (fwd_layout(h, w, cuda_cg.CLUSTER_THREADS),
               bwd_layout(h, w, cuda_fluid.BWD_THREADS, k))
        if got != want:
            raise AssertionError(f"fused_*_layout({h}, {w}) = {got}, the "
                                 f"Python count says {want}")
    for name, layout in (("K2", cuda_fluid.fwd_layout),
                         ("K3", lambda h, w: cuda_fluid.bwd_layout(h, w, k))):
        for kind in (cuda_cg.LARGE, cuda_cg.BANDED):
            print(f"{name} {cuda_cg.LAYOUT_NAMES[kind]} layout at " + ", ".join(
                f"{h}x{w}" for h, w in layout_shapes if layout(h, w) == kind)
                + " (the kernel's and the Python count agree)")
    big = FUSED_BIG
    print(f"K2 plan at {big}x{big}x{BATCH}: "
          f"{_plan_text(cuda_fluid.fwd_plan(BATCH, big, big))}; resident "
          "clusters: " + ", ".join(
              f"C={p.cluster}: {cuda_fluid._kernels()[3](big, big, p.cluster, p.threads)}"
              for p in cuda_fluid.fwd_plans(big, big)))
    print(f"K3 plan at {big}x{big}x{BATCH}: "
          f"{_plan_text(cuda_fluid.bwd_plan(BATCH, big, big, k))}; resident "
          "clusters: " + ", ".join(
              f"C={p.cluster}: {cuda_fluid._kernels()[2](big, big, p.cluster, p.threads, k)}"
              for p in cuda_fluid.bwd_plans(big, big, k)))
    fn = lib.fused_bwd_shared_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_size_t
    scratch = lib.fused_bwd_scratch_floats
    scratch.argtypes, scratch.restype = [ctypes.c_int] * 5, ctypes.c_size_t
    bwd_cases = [(h, w, c, cuda_fluid.BWD_THREADS)
                 for h, w in ((H, H), (32, 32), (32, 48), (8, 8), (84, 84),
                              (96, 96), (112, 112), (128, 128), (64, 128),
                              *FUSED_BANDED_SHAPES)
                 for c in cuda_fluid.BWD_CLUSTERS if c <= h]
    for h, w, c, t in bwd_cases:
        want = cuda_fluid.bwd_shared_bytes(h, w, c, t, FUSED_STEP["max_shift"])
        if fn(h, w, c, t, FUSED_STEP["max_shift"]) != want:
            raise AssertionError(f"fused_bwd_shared_bytes({h}, {w}, {c}, {t}): "
                                 f"kernel asks {fn(h, w, c, t, 2)} bytes, the "
                                 f"plan counts {want}")
        want = cuda_fluid.bwd_scratch_floats(h, w, c, FUSED_STEP["max_shift"])
        if scratch(h, w, c, t, FUSED_STEP["max_shift"]) != want:
            raise AssertionError(f"fused_bwd_scratch_floats({h}, {w}, {c}): "
                                 f"kernel {scratch(h, w, c, t, 2)}, the "
                                 f"wrapper allocates {want}")
    for batch in (BATCH, 64):
        plan = cuda_fluid.bwd_plan(batch, H, H, FUSED_STEP["max_shift"])
        if fn(H, H, plan.cluster, plan.threads, 2) != plan.shared_bytes:
            raise AssertionError(f"bwd_plan {plan}: the kernel asks "
                                 f"{fn(H, H, plan.cluster, plan.threads, 2)} bytes")
        print(f"K3 plan at {H}x{H}x{batch}: {_plan_text(plan)}")
    print(f"fused_bwd_shared_bytes and fused_bwd_scratch_floats equal to the "
          f"plan's and the wrapper's counts at {len(bwd_cases)} cases")
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
# do not divide evenly, the largest of the small layout the tests hold to
# plain, and smoke_128's (the large layout), closed with the plate.
K1_BIG = 128
K1_SHAPES = ((H, True), (32, False), (48, True), (96, True), (K1_BIG, True))
CG_GOLDENS = "tests/goldens/pcg_32.npz"
# `scripts/make_cg_goldens_128.py`'s golden (closed box with the plate,
# batch 2, tol 1e-6 / maxiter 200), as `cg_golden_files_check` takes it.
CG_GOLDENS_128 = {"tests/goldens/pcg_128.npz": {"cold": (K1_BIG, False),
                                                "warm": (K1_BIG, True)}}


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
    summary["cold"]["err"] = max(summary["cold"]["err"],
                                 cg_golden_files_check(dev, CG_GOLDENS_128))

    # Times at 128²×8 (smoke_128's solve: tol 1e-4, maxiter 200), under
    # solve_plan's plan and every other, beside plain and the bound.
    n = K1_BIG
    domain = Domain2D.create(n, n, obstacle_mask=_plate(n), device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    div = torch.tensor(rng.normal(size=(BATCH, n, n)), dtype=torch.float32,
                       device=dev)
    p_prev = cuda_cg.pcg_plain(div, *geom, tol=1e-6, maxiter=500)[0]
    x0 = (p_prev + 0.05 * p_prev.std() * torch.tensor(
        rng.normal(size=(BATCH, n, n)), dtype=torch.float32,
        device=dev)).contiguous()
    main_plan = cuda_cg.solve_plan(BATCH, n, n)
    big = {}
    for start, guess in (("cold", None), ("warm", x0)):
        args = dict(x0=guess, dx=domain.dx, closed=True, tol=1e-4, maxiter=200)
        p_p, it_p = cuda_cg.pcg_plain(div, *geom, **args)
        plain_ms = _time_ms(lambda: cuda_cg.pcg_plain(div, *geom, **args), 3)
        for plan in cuda_cg.solve_plans(n, n):
            kw = dict(args, precond=True)
            del kw["x0"]
            p_k, it_k = cuda_cg._launch_solve(div, *geom, guess, plan, **kw)
            ms = _time_ms(lambda: cuda_cg._launch_solve(div, *geom, guess, plan,
                                                        **kw), 20)
            nbytes = _nbytes(div, guess, p_k) + 4 * BATCH + _geom_bytes(n, n)
            bound_ms, bound_by = _bound(nbytes, _cg_flops(n, n, it_k))
            mark = " (solve_plan's)" if plan == main_plan else ""
            print(f"  time per solve {n}x{n}x{BATCH} {start} tol 1e-4 maxiter "
                  f"200, {_plan_text(plan)}{mark}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}); "
                  f"trips {it_k.tolist()} (plain {it_p.tolist()}); max|dp|/"
                  f"max|p| {float((p_k - p_p).abs().max() / p_p.abs().max()):.2e}"
                  f" [{card}]")
            if plan == main_plan:
                big[start] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by,
                                  trips=float(it_k.float().mean()))
    summary["big"] = dict(
        {f"{k}_{key}": v for k, s in big.items() for key, v in s.items()},
        plan=dict(main_plan._asdict(), batch=BATCH, h=n, w=n,
                  layout=cuda_cg.LAYOUT_NAMES[cuda_cg.layout(n, n)]))

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
# a width that is not a multiple of 4), one row a rank under C = 8; 96², the
# small layout beyond the sides of the first fused PRs; 112² and 128²
# (smoke_128's grid), the cluster core's large layout with even bands under
# C = 8 and 16; 127², the large layout with bands of unequal rows under
# both; 110², K2 in the large layout and K3 in the small one; and 64×128,
# the small layout with a 128-wide basis.
FUSED_BIG = 128
FUSED_SHAPES = ((H, H), (32, 32), (32, 48), (24, 30), (8, 8), (96, 96),
                (110, 110), (112, 112), (127, 127), (FUSED_BIG, FUSED_BIG),
                (64, 128))
# The JAX package's fused step and VJP: 32² (scripts/make_fused_goldens.py)
# and 128² (scripts/make_fused_goldens_128.py), each batch 2.
GOLDENS = {32: "tests/goldens/fused_step_32.npz",
           FUSED_BIG: "tests/goldens/fused_step_128.npz"}


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


def _agree(label: str, got, want, names, limit: float, nonfinite: bool,
           trips_frac: float = 0.0) -> tuple:
    """Each output within `limit` of the reference's max|ref| over its
    finite cells, the non-finite cells exactly the reference's (none unless
    `nonfinite`), trip counts within 3 (or `trips_frac` of the reference's
    largest, if more) when both sides return them. Returns ({name:
    max|d|/max|ref|}, the largest max|d|, the non-finite cells)."""
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
        most = max(3, int(trips_frac * int(want[-1].max())))
        if dit > most:
            raise AssertionError(f"{label}: trip counts differ by {dit} > {most}")
    return rels, worst, n_bad


def _same_bits(label: str, a: tuple, b: tuple) -> None:
    for x, y in zip(a, b):
        if x is not None and not torch.equal(x.view(torch.int32), y.view(torch.int32)):
            raise AssertionError(f"{label}: two calls differ")


def fused_golden_check(dev, path: str, h: int, w: int, grid: str = "",
                       trips_frac: float = 0.0) -> dict:
    """K2 and K3 (each under its plan and every plan its launcher takes at
    H x W) against the JAX package's fused step and VJP, from the golden
    file `path` (its arrays under `grid/` where it holds more grids than
    one): outputs within 1e-4, cotangents within 1e-3 of the golden's
    max|ref|; where the golden has them (128² and beyond), trip counts
    within 3 (or `trips_frac` of the golden's, if more) of the JAX
    package's CG on the same systems (`trips`)."""
    from pathlib import Path

    from pde_control_tpu_torch.ops import cuda_cg, cuda_fluid

    z = np.load(Path(__file__).resolve().parent / path)
    cfg = json.loads(str(z["config"]))
    trips = cfg.get("trips")
    if trips is not None and grid:
        trips = trips[grid]
    prefix = f"{grid}/" if grid else ""
    kw = {k: cfg[k] for k in ("dt", "dx", "max_shift", "buoyancy", "closed",
                              "tol", "maxiter")}

    def t(key):
        return torch.tensor(z[prefix + key].astype(np.float32), device=dev)

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
        rel_f, dit = 0.0, 0

        def trips_off(got, where, plan):
            if trips is None:
                return 0
            d = int(np.abs(got.cpu().numpy() - trips[case][where]).max())
            if d > max(3, int(trips_frac * max(trips[case][where]))):
                raise AssertionError(f"golden {h}x{w} {case} {where} {plan}: "
                                     f"trip counts {got.tolist()} against the "
                                     f"JAX CG's {trips[case][where]}")
            return d

        for plan in [None] + cuda_fluid.fwd_plans(h, w):
            out = cuda_fluid._launch_forward(vy, vx, rho, *geom, fy, fx, inflow,
                                             x0, plan, **kw)
            rels, worst, _ = _agree(f"golden {h}x{w} {case} fwd {plan}", out[:4],
                                    want, names_f, 1e-4, False)
            err["fwd"] = max(err["fwd"], worst)
            rel_f = max(rel_f, max(rels.values()))
            dit = max(dit, trips_off(out[4], "fwd", plan))
        names_b = ("vy", "vx", "rho", "fy", "fx", "inflow")
        want = [None if zero_v and n == "inflow" else t(f"{case}/d_{n}")
                for n in names_b]
        rel_b = 0.0
        for plan in [None] + cuda_fluid.bwd_plans(h, w):
            got = cuda_fluid._launch_backward(vy, vx, rho, *cots, *geom, plan,
                                              has_force=True, has_inflow=not zero_v,
                                              **kw)
            rels_b, worst, _ = _agree(f"golden {h}x{w} {case} bwd {plan}",
                                      got[:6], want, names_b, 1e-3, False)
            err["bwd"] = max(err["bwd"], worst)
            rel_b = max(rel_b, max(rels_b.values()))
            dit = max(dit, trips_off(got[6], "bwd", plan))
        layout = (cuda_cg.LAYOUT_NAMES[cuda_fluid.fwd_layout(h, w)],
                  cuda_cg.LAYOUT_NAMES[cuda_fluid.bwd_layout(h, w,
                                                             kw["max_shift"])])
        print(f"golden {h}x{w}x{len(rho)} {case} (JAX interpret-mode kernels): "
              f"worst max|d|/max|ref| over the plan and every other: K2 "
              f"{rel_f:.2e} ({len(cuda_fluid.fwd_plans(h, w))} plans, "
              f"{layout[0]} layout), K3 {rel_b:.2e} "
              f"({len(cuda_fluid.bwd_plans(h, w))} plans, {layout[1]} layout)"
              + (f"; trip counts within {dit} of the JAX CG's" if trips else ""))
    return err


def _fused_against_plain(dev, rng, h: int, w: int, err: dict, *,
                         closed: bool = True, trips_frac: float = 0.0) -> None:
    """K2 and K3 at H x W, batch 8, with the plate, in every case of
    `FUSED_CASES`, against their plain versions on the card at tol 1e-6 /
    500: under their plans and under every plan their launchers take, each
    twice for the same bits, at `_agree`'s limits (outputs 1e-4,
    cotangents 1e-3, trips within 3 or `trips_frac`). Raises `err`'s "fwd"
    and "bwd" to the largest max|d|."""
    from pde_control_tpu_torch.grids import Domain2D
    from pde_control_tpu_torch.ops import cuda_cg, cuda_fluid

    names_f = ("vy4", "vx4", "rho1", "p")
    names_b = ("g_vy", "g_vx", "g_rho", "g_fy", "g_fx", "g_inflow")
    domain = Domain2D.create(h, w, obstacle_mask=_plate(h, w), closed=closed,
                             device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    plans = cuda_fluid.bwd_plans(h, w)
    fwd_plans = cuda_fluid.fwd_plans(h, w)
    print(f"{h}x{w}{'' if closed else ' open'}: K2 in the "
          f"{cuda_cg.LAYOUT_NAMES[cuda_fluid.fwd_layout(h, w)]} layout, K3 "
          f"in the {cuda_cg.LAYOUT_NAMES[cuda_fluid.bwd_layout(h, w)]}")
    for case in FUSED_CASES:
        label = f"{h}x{w} {case}"
        nonfinite = case == "non-finite"
        ops, cots = _fused_operands(rng, h, w, case, domain, dev)
        kw = dict(FUSED_STEP, dx=domain.dx, tol=1e-6, maxiter=500,
                  closed=closed)
        state = (ops.pop("vy"), ops.pop("vx"), ops.pop("rho"))
        out_k = cuda_fluid.fused_step_forward(*state, *geom, **ops, **kw)
        out_p = cuda_fluid.fused_step_plain_forward(*state, *geom, **ops, **kw)
        rels, worst, n_bad = _agree(f"{label} fwd", out_k, out_p, names_f,
                                    1e-4, nonfinite, trips_frac)
        err["fwd"] = max(err["fwd"], worst)
        worst_rel, trips = 0.0, set()
        step_ops = [ops.get(k) for k in ("fy", "fx", "inflow", "x0")]
        for plan in fwd_plans:
            got, again = (cuda_fluid._launch_forward(
                *state, *geom, *step_ops, plan, **kw) for _ in range(2))
            r, d, _ = _agree(f"{label} fwd {plan}", got, out_p, names_f,
                             1e-4, nonfinite, trips_frac)
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
                                    nonfinite, trips_frac)
        err["bwd"] = max(err["bwd"], worst)
        worst_rel, trips = 0.0, set()
        for plan in plans:
            got, again = (cuda_fluid._launch_backward(
                *state, *cots, *geom, plan, **flags, **kw) for _ in range(2))
            r, d, _ = _agree(f"{label} bwd {plan}", got, g_p, names_b, 1e-3,
                             nonfinite, trips_frac)
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
    err = {"fwd": 0.0, "bwd": 0.0}
    for h, w in FUSED_SHAPES:
        _fused_against_plain(dev, rng, h, w, err)
    for n, path in GOLDENS.items():
        golden = fused_golden_check(dev, path, n, n)
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

    # Times at 128²×8, smoke_128's step, both kernels in the large layout.
    summary["fwd"]["128x8"], summary["bwd"]["128x8"] = _fused_times(
        card, dev, rng, FUSED_BIG)
    return summary


def _fused_times(card: str, dev, rng, n: int) -> tuple[dict, dict]:
    """K2's and K3's times at n²×8, the slices' settings (smoke_128's step:
    force, warm start, tol 1e-4 / maxiter 200, max_shift 2): events over a
    host loop, graph replay beside them, the plain versions and the bounds
    counted as at 64², under the plan, in the grid's layout; and the split
    into the rest (graph replay at maxiter 0: the windows, their adjoints
    and one preconditioner application) and µs a trip of the sample with
    the most. Returns each kernel's numbers."""
    from pde_control_tpu_torch.grids import Domain2D
    from pde_control_tpu_torch.ops import cuda_cg, cuda_fluid

    domain = Domain2D.create(n, n, obstacle_mask=_plate(n), device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    ops, cots = _fused_operands(rng, n, n, "warm", domain, dev)
    kw = dict(FUSED_STEP, dx=domain.dx, tol=1e-4, maxiter=200)
    state = (ops.pop("vy"), ops.pop("vx"), ops.pop("rho"))
    flags = dict(has_force=True, has_inflow=False)
    out = cuda_fluid.fused_step_forward(*state, *geom, **ops, **kw)
    grads = cuda_fluid.fused_step_backward(*state, *cots, *geom, **flags, **kw)
    cells = _window_cells(BATCH, n, n)
    k = FUSED_STEP["max_shift"]
    kernels = {
        "fwd": ("K2", lambda: cuda_fluid.fused_step_forward(
                    *state, *geom, **ops, **kw),
                lambda: cuda_fluid.fused_step_plain_forward(
                    *state, *geom, **ops, **kw),
                _nbytes(*state, *ops.values(), *out[:4]), out[4], False,
                cuda_fluid.fwd_plan(BATCH, n, n), cuda_fluid.fwd_layout(n, n)),
        "bwd": ("K3", lambda: cuda_fluid.fused_step_backward(
                    *state, *cots, *geom, **flags, **kw),
                lambda: cuda_fluid.fused_step_plain_backward(
                    *state, *cots, *geom, **flags, **kw),
                _nbytes(*state, *cots, *grads[:6]), grads[6], True,
                cuda_fluid.bwd_plan(BATCH, n, n, k),
                cuda_fluid.bwd_layout(n, n, k)),
    }
    times = {}
    rest = {"fwd": lambda: cuda_fluid.fused_step_forward(
                *state, *geom, **ops, **dict(kw, maxiter=0)),
            "bwd": lambda: cuda_fluid.fused_step_backward(
                *state, *cots, *geom, **flags, **dict(kw, maxiter=0))}
    for where, (name, kernel, plain, nbytes, iters, adjoint, plan,
                layout) in kernels.items():
        kernel_ms, plain_ms = _time_ms(kernel, 20), _time_ms(plain, 3)
        graph_ms = _graph_ms(kernel, 10)
        rest_ms = _graph_ms(rest[where], 10)
        us_per_trip = 1e3 * (graph_ms - rest_ms) / max(int(iters.max()), 1)
        flops = cells * (_window_flops(adjoint) + 20) + _cg_flops(n, n, iters)
        nbytes += 4 * BATCH
        bound_ms, bound_by = _bound(nbytes + _geom_bytes(n, n), flops)
        layout = cuda_cg.LAYOUT_NAMES[layout]
        print(f"  time per {where} launch {n}x{n}x{BATCH} warm, force, tol 1e-4 "
              f"maxiter 200 (trips {iters.tolist()}): {name} {kernel_ms:.4f} ms "
              f"(graph replay {graph_ms:.4f}), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by}; {flops / 1e6:.1f} MFLOP, "
              f"{nbytes / 1e6:.2f} MB); {_plan_text(plan)}, {layout} layout; "
              f"at maxiter 0 {rest_ms:.4f} ms by graph replay, so "
              f"{us_per_trip:.1f} µs a trip of the most [{card}]")
        times[where] = dict(
            ms=kernel_ms, graph_ms=graph_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, rest_ms=rest_ms,
            us_per_trip=us_per_trip,
            trips=float(iters.float().mean()),
            plan=dict(plan._asdict(), batch=BATCH, h=n, w=n, layout=layout))
    return times["fwd"], times["bwd"]


# ------------------------------------------------ the 128² and 236² fused apps

# The slices at smoke_128's grid and at the Pallas fluid gate's square edge:
# `profile_bench.make_app(h, 16, 8, maxiter=200)` (the plate, buoyancy
# control, a warm-started solve at tol 1e-4, CFE 32-64-64-32, OP16-OP2 at
# base 16 and 3 levels, bf16 nets), its fused step on K2/K3 against the
# same app unfused on K1 (at 236² both in the banded layout).
BIG_APP = dict(n=N, batch=BATCH, maxiter=200)


def _fused_app(h: int, fused: str, sequence_class: str = "staggered"):
    from pde_control_tpu_torch.experiments import profile_bench

    return profile_bench.make_app(
        h, BIG_APP["n"], BIG_APP["batch"], "cuda", maxiter=BIG_APP["maxiter"],
        fused=fused, sequence_class=sequence_class)


def _fused_app_eager(card: str, h: int, batch: dict, fused_iter: dict) -> dict:
    """Two eager iterations of the fused h² app after a warm-up: ms an
    iteration, peak memory, launches. Returns the launches an iteration."""
    app = _fused_app(h, "cuda")
    on_card = app.to_batch(batch)
    app.progress(on_card)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    losses = [app.progress(on_card)["loss"] for _ in range(2)]
    end.record()
    torch.cuda.synchronize()
    eager = _counts()
    losses = [float(x) for x in losses]
    print(f"fused {h}x{h} eager: {start.elapsed_time(end) / 2:.3f} ms an "
          f"iteration (CUDA events), losses {losses}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, launches in 2 "
          f"iterations {eager} [{card}]")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"fused {h}x{h}: non-finite loss {losses}")
    _expect(f"fused {h}x{h} eager", eager, fused_iter, iters=2)
    del app, on_card
    torch.cuda.empty_cache()
    return {k: v // 2 for k, v in eager.items()}


def fused128_phase(card: str) -> dict:
    """`fused_app_phase` at 128², both classes, with eager iterations."""
    _phase("128², fused (K2 / K3)")
    return fused_app_phase(card, FUSED_BIG)


def fused_app_phase(card: str, h: int, seqs=("staggered", "chain"),
                    eager: bool = True) -> dict:
    """The h² training iteration under fused='cuda' (K2/K3) beside the
    same app unfused (K1): the first iteration of both on the same perturbed
    weights and batch (loss 1e-3 relative, each net's gradient norm within
    2e-2), the launches of an iteration (16 K2, 16 K3, 0 K1 fused), eager
    iterations (if `eager`), then `progress_multi`'s CUDA graph for each
    class of `seqs` on both apps: ms a step, peak and reserved memory,
    capture seconds and graph nodes. Returns the fused app's launches in
    the first iteration, per eager iteration and per replay of each class,
    and ms a step under each graph."""
    from pde_control_tpu_torch.experiments import profile_bench

    n, b = BIG_APP["n"], BIG_APP["batch"]
    batch = profile_bench.make_batch(h, n, b, SEED)
    fused_iter = {"K1": 0, "K2": n, "K3": n, "K4 fwd": 0, "K4 dX": 0, "K5": 0}
    first = {}
    for fused in ("cuda", "auto"):
        app = _fused_app(h, fused)
        perturb_cfe(app)
        _zero_counts()
        metrics = app.compute_gradients(app.to_batch(batch))
        torch.cuda.synchronize()
        first[fused] = ((float(metrics["loss"]), _grad_norms(app)), _counts())
        del app, metrics
    print(f"{h}x{h} n={n} batch={b} first iteration launches: fused "
          f"{first['cuda'][1]}, unfused {first['auto'][1]}")
    _compare_first(f"fused {h}x{h}", first["cuda"][0], first["auto"][0])
    if first["cuda"][1] != fused_iter:
        raise AssertionError(f"fused {h}x{h}: an iteration launched "
                             f"{first['cuda'][1]}, expected {fused_iter}")
    out = {"first": first["cuda"][1]}
    if eager:
        out["eager"] = _fused_app_eager(card, h, batch, fused_iter)

    # progress_multi's CUDA graph: K_MULTI replays a call, after the call
    # that warms up and captures.
    stacked = [profile_bench.make_batch(h, n, b, SEED + 30 + i)
               for i in range(K_MULTI)]
    batches = {k: torch.tensor(np.stack([x[k] for x in stacked]), device="cuda")
               for k in stacked[0]}
    for seq in seqs:
        ms = {}
        for fused, path in (("cuda", "fused"), ("auto", "unfused")):
            app = _fused_app(h, fused, seq)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            app.progress_multi(batches)  # warm-up, capture and K replays
            torch.cuda.synchronize()
            first_call = time.perf_counter() - t0
            graph = next(iter(app._graphs.values()))
            capture = dict(capture_s=graph.capture_s,
                           instantiate_s=graph.instantiate_s,
                           nodes=_graph_nodes(graph.graph))
            timed = _timed_steps(f"{h}x{h} {seq} {path} graph", app, batches,
                                 card, True)
            per_step = {k: v // K_MULTI for k, v in timed["launches"].items()}
            print(f"{h}x{h} {seq} {path}: first progress_multi call "
                  f"{first_call:.2f} s, {_capture_text(capture)} [{card}]")
            if path == "fused":
                _expect(f"{h}x{h} {seq} fused graph", per_step, fused_iter,
                        iters=1)
                out[seq] = per_step
            ms[path] = timed["ms"]
            del app, graph
            torch.cuda.empty_cache()
        print(f"{h}x{h} {seq}: fused {ms['fused']:.3f} ms a step under the "
              f"graph against unfused {ms['unfused']:.3f} "
              f"({ms['unfused'] / ms['fused']:.2f}x) [{card}]")
        out[f"{seq}_ms"] = ms
    return out


# ------------------------------------------- K1 beyond 128² (banded layout)

# K1's grids beyond 128², closed with the plate: the large layout's sides
# beyond smoke_128's (129², and 153², its last), the banded layout's first
# (154²), bands of unequal rows (192², 257²), the indirect-smoke task's
# 256², the C = 8 / C = 16 boundary (288² takes both, 289² 16 alone), the
# Pallas gate's edges (351², its largest warm square, and 362², its largest
# cold one; both starts run at each), the non-square grids the gate admits
# (96×320, 320×96) and 8×1000 (the large layout, one row a rank). Batch 8.
# 8×1000 is an open box (`K1_OPEN`): in a closed one the spectral
# preconditioner's lowest mode along the 1000 cells (1/λ ~ 1e5) amplifies
# fp32 rounding so far that neither the plain version nor the kernel
# converges (relative residuals 0.01-0.3 after 200 and 500 trips, with a
# plate of w/4 or of h cells), which leaves nothing to hold the kernel to;
# open, the walls' Dirichlet modes keep it well conditioned (18-23 trips).
K1_BANDED_SHAPES = [(129, 129), (153, 153), (154, 154), (192, 192),
                    (256, 256), (257, 257), (288, 288), (289, 289),
                    (351, 351), (362, 362), (96, 320), (320, 96), (8, 1000)]
# K1's timed grids there (batch 8, tol 1e-4 / maxiter 200, the task's).
K1_OPEN = {(8, 1000)}
K1_BANDED_TIMED = (256, 351)
# `scripts/make_cg_goldens_big.py`'s goldens: file -> {case: (side, warm)};
# pcg_256.npz keeps one set of operands, unprefixed, pcg_edges.npz one a
# case, under the case's name.
CG_GOLDENS_BIG = {"tests/goldens/pcg_256.npz": {"cold": (256, False),
                                                "warm": (256, True)},
                  "tests/goldens/pcg_edges.npz": {"351-warm": (351, True),
                                                  "362-cold": (362, False)}}
# The 256² app: `fluid2d.run_smoke_indirect(size=256)`'s task at full
# widths (`default_obstacles`, an inflow plume, buoyancy control, CFE
# 48-96-96-48, OP16-OP2 U-nets of 3 levels at base width 16, tol 1e-4 /
# maxiter 200, warm start, bf16 nets on cuDNN), unfused; `k` steps a
# `progress_multi` call.
APP256 = dict(size=256, n=N, batch=BATCH, k=2)
# `run_smoke_indirect(size=256)` cut as `ENTRIES` cuts the plated task:
# 8 + 8 trajectories (warm-up 8 steps, 16 recorded), 8 iterations a
# stage, one progress_multi call (full: 256 + 32, 500).
SMOKE256 = dict(size=256, n=16, batch=8, num_train=8, num_val=8,
                iterations=8, warmup=8)


def _k1_against_plain(dev, rng, h: int, w: int) -> dict:
    """K1 at H x W, batch 8, with the plate, closed (open in `K1_OPEN`),
    cold and warm (5% noise on the plain solution), tol 1e-4 / maxiter 200
    (the task's) and
    1e-5 / 500, under `solve_plan`'s plan and every plan its launcher
    takes, against `pcg_plain` at `kernel_phase`'s limits. Not 1e-6 as
    `kernel_phase` does to 128²: on these grids fp32 reaches a relative
    residual of ~5e-5 (the plain version's at tol 1e-6), so there the
    stopping trip is set by rounding (at 351² warm the kernel and the plain
    version stopped 9 trips apart with the same residual, 5.20e-05 and
    5.24e-05, and solutions 1.3e-06 apart). Returns the worst of each."""
    from pde_control_tpu_torch.grids import Domain2D
    from pde_control_tpu_torch.ops import cuda_cg
    from pde_control_tpu_torch.physics.poisson import (
        _projector,
        masked_laplace_spd,
    )

    closed = (h, w) not in K1_OPEN
    domain = Domain2D.create(h, w, obstacle_mask=_plate(h, w), closed=closed,
                             device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    fluid = domain.fluid_mask > 0
    div = torch.tensor(rng.normal(size=(BATCH, h, w)), dtype=torch.float32,
                       device=dev)
    b = torch.where(fluid, -div, 0.0)
    if closed:
        b = _projector(domain)(b)
    p_prev = cuda_cg.pcg_plain(div, *geom, closed=closed, tol=1e-6,
                               maxiter=500)[0]
    x0 = (p_prev + 0.05 * p_prev.std() * torch.tensor(
        rng.normal(size=(BATCH, h, w)), dtype=torch.float32,
        device=dev)).contiguous()
    plans = cuda_cg.solve_plans(h, w)

    def rel_res(p):
        r = torch.where(fluid, b - masked_laplace_spd(p, domain), 0.0)
        return float((r.norm(dim=(1, 2)) / b.norm(dim=(1, 2))).max())

    worst = dict(rel=0.0, res=0.0, dit=0, err=0.0)
    for tol, maxiter in ((1e-4, 200), (1e-5, 500)):
        for start, guess in (("cold", None), ("warm", x0)):
            kw = dict(dx=domain.dx, closed=closed, tol=tol, maxiter=maxiter)
            p_p, it_p = cuda_cg.pcg_plain(div, *geom, guess, **kw)
            res_p = rel_res(p_p)
            label = (f"{h}x{w} {cuda_cg.LAYOUT_NAMES[cuda_cg.layout(h, w)]} "
                     f"{'closed' if closed else 'open'} {start} tol={tol:g}")
            for plan in [None] + plans:
                p_k, it_k = cuda_cg._launch_solve(div, *geom, guess, plan,
                                                  precond=True, **kw)
                torch.cuda.synchronize()
                err = float((p_k - p_p).abs().max())
                rel = err / float(p_p.abs().max())
                res_k = rel_res(p_k)
                dit = int((it_k - it_p).abs().max())
                if not torch.isfinite(p_k).all():
                    raise AssertionError(f"{label} {plan}: non-finite values")
                if res_k > max(2.0 * tol, 2.0 * res_p):
                    raise AssertionError(f"{label} {plan}: kernel residual "
                                         f"{res_k:.3e} above tol {tol:g}")
                if rel > 100 * tol:
                    raise AssertionError(f"{label} {plan}: kernel differs "
                                         f"from plain by {rel:.3e}")
                if dit > 3:
                    raise AssertionError(f"{label} {plan}: trip counts differ "
                                         f"by {dit} > 3: kernel "
                                         f"{it_k.tolist()}, plain "
                                         f"{it_p.tolist()}")
                for key, v in (("rel", rel), ("res", res_k), ("dit", dit),
                               ("err", err)):
                    worst[key] = max(worst[key], v)
            print(f"{label}: {len(plans)} plans (C = "
                  f"{', '.join(str(p.cluster) for p in plans)}) and solve_plan's;"
                  f" residual plain {res_p:.2e}, trips plain "
                  f"{it_p.tolist()}")
    print(f"  {h}x{w}: worst max|dp|/max|p| {worst['rel']:.2e}, residual "
          f"{worst['res']:.2e}, trip counts within {worst['dit']}")
    return worst


def cg_golden_files_check(dev, files: dict) -> float:
    """K1 under its plan and every plan its launcher takes against the JAX
    package's solves in `files` (`CG_GOLDENS_128`: 128², the large layout;
    `CG_GOLDENS_BIG`: 256², 351² warm and 362² cold, the banded one; closed
    boxes with the plate, tol 1e-6): the pressure within 1e-4 of the
    golden's max|p|, trip counts within 1 of the JAX package's CG. Returns
    the largest max|dp|."""
    from pathlib import Path

    from pde_control_tpu_torch.ops import cuda_cg

    worst = 0.0
    for path, cases in files.items():
        z = np.load(Path(__file__).resolve().parent / path)
        kw = dict(json.loads(str(z["config"])), closed=True, precond=True)
        for case, (side, warm) in cases.items():
            prefix = f"{case}/" if f"{case}/div" in z else ""

            def t(key):
                return torch.tensor(z[prefix + key].astype(np.float32),
                                    device=dev)

            geom = [t(k) for k in ("acc_y", "acc_x", "fluid")]
            want = torch.tensor(z[f"{case}/p"], device=dev)
            trips = z[f"{case}/trips"]
            plans = cuda_cg.solve_plans(side, side)
            rel, dit = 0.0, 0
            for plan in [None] + plans:
                p, it = cuda_cg._launch_solve(t("div"), *geom,
                                              t("x0") if warm else None, plan,
                                              **kw)
                d = float((p - want).abs().max())
                worst, rel = max(worst, d), max(rel, d / float(want.abs().max()))
                dit = max(dit, int(np.abs(it.cpu().numpy() - trips).max()))
            print(f"golden {side}x{side}x{len(trips)} {case} (JAX interpret-mode"
                  f" kernel, trips {trips.tolist()}): K1 "
                  f"{cuda_cg.LAYOUT_NAMES[cuda_cg.layout(side, side)]} worst "
                  f"max|dp|/max|p| over its plan and {len(plans)} others "
                  f"{rel:.2e}, trips within {dit}")
            if rel > 1e-4 or dit > 1:
                raise AssertionError(f"K1 at {side}^2 differs from the JAX "
                                     f"golden {case}: {rel:.3e} > 1e-4 or "
                                     f"trips by {dit}")
    return worst


CG_GOLDEN_CLOSED = "tests/goldens/pcg_closed.npz"


def cg_closed_golden_check(dev) -> float:
    """K1 under its plan and every plan its launcher takes against the JAX
    package's cold solve on a closed 64×600 box with the plate
    (`scripts/make_cg_goldens_closed.py`, tol 1e-6 / 500, batch 4), where
    the 4× rule stops one sample's solve at its best iterate of trip 7 in
    the Pallas kernel and in the plain version alike. The samples the
    golden converged: the pressure within 1e-4 of the sample's max|p|,
    trips within 3 or 10% of the trip of the Pallas kernel's best iterate.
    The sample it stopped: K1 converges (relative residual ‖b − A p‖ / ‖b‖
    within 1e-3; the golden's converged samples reach 2-3e-4), or it stops
    too, within 3 or 10% of the golden's trip, at a residual no larger
    than the golden's. The safeguard fires on an fp32 rounding event and
    the iterate it keeps is as sensitive to rounding: K1's sums run in
    another order (on the card K1 converged under two of its plans and
    stopped at trip 10, 7.8e-3 of max|p| from the golden, under the
    third). Returns the largest max|dp| over the converged samples."""
    from pathlib import Path

    from pde_control_tpu_torch.grids import Domain2D
    from pde_control_tpu_torch.ops import cuda_cg
    from pde_control_tpu_torch.physics.poisson import (
        _projector,
        masked_laplace_spd,
    )

    z = np.load(Path(__file__).resolve().parent / CG_GOLDEN_CLOSED)
    kw = dict(json.loads(str(z["config"])), precond=True)
    del kw["warm"]
    t = {k: torch.tensor(z[k].astype(np.float32), device=dev)
         for k in ("div", "acc_y", "acc_x", "fluid", "p")}
    h, w = z["div"].shape[1:]
    domain = Domain2D.create(h, w, obstacle_mask=_plate(h, w), device=dev)
    if not all(torch.equal(getattr(domain, k), t[g]) for k, g in (
            ("acc_y", "acc_y"), ("acc_x", "acc_x"), ("fluid_mask", "fluid"))):
        raise AssertionError("the golden's geometry is not the plate's")
    fluid = domain.fluid_mask > 0
    b = _projector(domain)(torch.where(fluid, -t["div"], 0.0))

    def rel_res(p):
        r = torch.where(fluid, b - masked_laplace_spd(p, domain), 0.0)
        return (r.norm(dim=(1, 2)) / b.norm(dim=(1, 2))).cpu().numpy()

    trips = z["trips"]
    stopped = z["rel_res"] > 1e-2
    scale = t["p"].abs().amax(dim=(1, 2))
    worst, rel, dit = 0.0, 0.0, 0
    plans = cuda_cg.solve_plans(h, w)
    for plan in [None] + plans:
        p, it = cuda_cg._launch_solve(t["div"], t["acc_y"], t["acc_x"],
                                      t["fluid"], None, plan, **kw)
        d = (p - t["p"]).abs().amax(dim=(1, 2))
        d_rel = (d / scale).cpu().numpy()
        it, res = it.cpu().numpy(), rel_res(p)
        near = np.abs(it - trips) <= np.maximum(3, 0.1 * trips)
        close = (d_rel <= 1e-4) & near
        as_good = (res <= 1e-3) | (near & (res <= z["rel_res"]))
        print(f"  {_plan_text(plan) if plan else 'its plan'}: trips {it.tolist()},"
              f" max|dp|/max|p| {[f'{x:.2e}' for x in d_rel]}, relative "
              f"residuals {[f'{x:.2e}' for x in res]}")
        if not close[~stopped].all() or not as_good[stopped].all():
            raise AssertionError(f"K1 at {h}x{w} closed differs from the JAX "
                                 "golden")
        worst = max(worst, float(d[torch.tensor(~stopped, device=dev)].max()))
        rel = max(rel, float(d_rel[~stopped].max()))
        dit = max(dit, int(np.abs(it - trips)[~stopped].max()))
    print(f"golden {h}x{w}x{len(trips)} closed (JAX interpret-mode kernel, best"
          f" trips {trips.tolist()}, relative residuals "
          f"{[f'{x:.2e}' for x in z['rel_res']]}): K1 "
          f"{cuda_cg.LAYOUT_NAMES[cuda_cg.layout(h, w)]} over its plan and "
          f"{len(plans)} others: converged samples max|dp|/max|p| {rel:.2e}, "
          f"trips within {dit}; the stopped sample as printed")
    return worst


def _k1_times(card: str, dev, rng, n: int) -> dict:
    """K1 at n²×8 (tol 1e-4 / maxiter 200, cold and warm) under every plan,
    beside the plain version, the bound and the 'pcg' route the port took
    there before K1 did (`solve_pressure(backend='pcg')`, no gradient).
    Returns solve_plan's plan's numbers."""
    from pde_control_tpu_torch.grids import Domain2D
    from pde_control_tpu_torch.ops import cuda_cg
    from pde_control_tpu_torch.physics.poisson import solve_pressure

    domain = Domain2D.create(n, n, obstacle_mask=_plate(n), device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    div = torch.tensor(rng.normal(size=(BATCH, n, n)), dtype=torch.float32,
                       device=dev)
    p_prev = cuda_cg.pcg_plain(div, *geom, tol=1e-6, maxiter=500)[0]
    x0 = (p_prev + 0.05 * p_prev.std() * torch.tensor(
        rng.normal(size=(BATCH, n, n)), dtype=torch.float32,
        device=dev)).contiguous()
    main_plan = cuda_cg.solve_plan(BATCH, n, n)
    out = {}
    for start, guess in (("cold", None), ("warm", x0)):
        kw = dict(dx=domain.dx, closed=True, tol=1e-4, maxiter=200)
        p_p, it_p = cuda_cg.pcg_plain(div, *geom, guess, **kw)
        plain_ms = _time_ms(lambda: cuda_cg.pcg_plain(div, *geom, guess, **kw), 3)
        with torch.no_grad():
            pcg_ms = _time_ms(lambda: solve_pressure(
                div, domain, tol=1e-4, maxiter=200, backend="pcg", x0=guess), 3)
        for plan in cuda_cg.solve_plans(n, n):
            p_k, it_k = cuda_cg._launch_solve(div, *geom, guess, plan,
                                              precond=True, **kw)
            ms = _time_ms(lambda: cuda_cg._launch_solve(
                div, *geom, guess, plan, precond=True, **kw), 10)
            nbytes = _nbytes(div, guess, p_k) + 4 * BATCH + _geom_bytes(n, n)
            bound_ms, bound_by = _bound(nbytes, _cg_flops(n, n, it_k))
            mark = " (solve_plan's)" if plan == main_plan else ""
            print(f"  time per solve {n}x{n}x{BATCH} {start} tol 1e-4 maxiter "
                  f"200, {_plan_text(plan)}{mark}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, 'pcg' route {pcg_ms:.4f} ms, bound "
                  f"{bound_ms:.6f} ms ({bound_by}); trips {it_k.tolist()} "
                  f"(plain {it_p.tolist()}); max|dp|/max|p| "
                  f"{float((p_k - p_p).abs().max() / p_p.abs().max()):.2e}"
                  f" [{card}]")
            if plan == main_plan:
                out[start] = dict(ms=ms, plain_ms=plain_ms, pcg_ms=pcg_ms,
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  trips=float(it_k.float().mean()))
    out["plan"] = dict(main_plan._asdict(), batch=BATCH, h=n, w=n,
                       layout=cuda_cg.LAYOUT_NAMES[cuda_cg.layout(n, n)])
    return out


def _app256(backend: str):
    """The 256² app (`APP256`) with the pressure solve on `backend`."""
    from pde_control_tpu_torch import (
        ControlTraining,
        Domain2D,
        FluidConfig,
        IncompressibleFluidPDE,
    )
    from pde_control_tpu_torch.experiments.curriculum import op_spans
    from pde_control_tpu_torch.experiments.fluid2d import default_obstacles

    h, n = APP256["size"], APP256["n"]
    domain = Domain2D.create(h, h, obstacle_mask=default_obstacles(h, h),
                             device="cuda")
    cfg = FluidConfig(dt=1.0, buoyancy=0.08, pressure_tol=1e-4,
                      pressure_maxiter=200, warm_start_pressure=True,
                      pressure_backend=backend)
    pde = IncompressibleFluidPDE(
        domain, cfg, control="buoyancy", with_inflow=True, unet_levels=3,
        cfe_features=(48, 96, 96, 48), op_base_features=16)
    return ControlTraining(
        n, pde, batch_size=APP256["batch"],
        trainable_networks=("CFE",) + tuple(f"OP{s}" for s in op_spans(n)),
        sequence_class="staggered", obs_loss_frames=(n,)).prepare()


def _batch256(seed: int) -> dict:
    """Targets, zero start velocity and the task's inflow (a plume source
    drawn as `generate_inflow_smoke_dataset` draws it) from a seed."""
    from pde_control_tpu_torch.data.generate import (
        inflow_draws,
        inflow_from_draws,
    )

    h, n, b = APP256["size"], APP256["n"], APP256["batch"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    inflow = inflow_from_draws(inflow_draws(gen, b, h), h, h)
    return {"obs": rng.uniform(0, 1, size=(b, n + 1, h, h, 1)).astype(np.float32),
            "vy0": np.zeros((b, h + 1, h), np.float32),
            "vx0": np.zeros((b, h, h + 1), np.float32),
            "inflow": inflow.cpu().numpy().astype(np.float32)}


def app256_phase(card: str) -> dict:
    """The 256² training iteration on K1 against the same app on the 'pcg'
    route: the first iteration of both on the same perturbed weights and
    batch (loss 1e-3 relative, each net's gradient norm within 2e-2), 31
    K1 an iteration; then `progress_multi`'s CUDA graph on both (ms a step,
    peak and reserved memory, capture seconds, graph nodes, K1 a replay).
    Returns K1's launches in the first iteration and a replay's."""
    h, n, b, k = (APP256[key] for key in ("size", "n", "batch", "k"))
    batch = _batch256(SEED)
    first = {}
    for backend in ("auto", "pcg"):
        app = _app256(backend)
        perturb_cfe(app)
        _zero_counts()
        metrics = app.compute_gradients(app.to_batch(batch))
        torch.cuda.synchronize()
        first[backend] = ((float(metrics["loss"]), _grad_norms(app)), _counts())
        del app, metrics
    print(f"{h}x{h} n={n} batch={b} first iteration launches: K1 route "
          f"{first['auto'][1]}, 'pcg' route {first['pcg'][1]}")
    _compare_first(f"K1 {h}x{h}", first["auto"][0], first["pcg"][0])
    want = {key: (2 * n - 1 if key == "K1" else 0) for key in first["auto"][1]}
    if first["auto"][1] != want or any(first["pcg"][1].values()):
        raise AssertionError(f"{h}x{h}: an iteration launched "
                             f"{first['auto'][1]} on K1's route (expected "
                             f"{want}) and {first['pcg'][1]} on 'pcg'")
    stacked = [_batch256(SEED + 30 + i) for i in range(k)]
    batches = {key: torch.tensor(np.stack([x[key] for x in stacked]),
                                 device="cuda") for key in stacked[0]}
    out = {"first": first["auto"][1]["K1"]}
    ms = {}
    for backend, path in (("auto", "K1"), ("pcg", "pcg")):
        app = _app256(backend)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        app.progress_multi(batches)  # warm-up, capture and k replays
        torch.cuda.synchronize()
        first_call = time.perf_counter() - t0
        graph = next(iter(app._graphs.values()))
        capture = dict(capture_s=graph.capture_s,
                       instantiate_s=graph.instantiate_s,
                       nodes=_graph_nodes(graph.graph))
        _zero_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        losses = app.progress_multi(batches)["loss"]
        end.record()
        torch.cuda.synchronize()
        if any(_counts().values()) or not torch.isfinite(losses).all():
            raise AssertionError(f"{h}x{h} {path}: a replay ran a wrapper "
                                 f"({_counts()}) or lost finite values")
        ms[path] = start.elapsed_time(end) / k
        launches = dict(app.graph_launches)
        print(f"{h}x{h} staggered on the '{backend}' route ({path}) under the "
              f"graph: "
              f"{ms[path]:.3f} ms a step ({k} replays, CUDA events), "
              f"{n * b / (ms[path] / 1e3):.1f} steps/s; first progress_multi "
              f"call {first_call:.2f} s, {_capture_text(capture)}; launches a "
              f"replay {launches}; peak {torch.cuda.max_memory_allocated() / 2**20:.1f}"
              f" MiB, reserved {torch.cuda.memory_reserved() / 2**20:.1f} MiB; "
              f"losses {[round(float(x), 7) for x in losses]} [{card}]")
        if launches != {key: (want[key] if backend == "auto" else 0)
                        for key in want}:
            raise AssertionError(f"{h}x{h} {path}: launches a replay {launches}")
        if backend == "auto":
            out["graph"] = launches["K1"]
        del app, graph
        torch.cuda.empty_cache()
    print(f"{h}x{h}: K1 {ms['K1']:.3f} ms a step under the graph against "
          f"'pcg' {ms['pcg']:.3f} ({ms['pcg'] / ms['K1']:.2f}x) [{card}]")
    out["ms"] = ms
    return out


def smoke256_run(card: str) -> dict:
    """`fluid2d.run_smoke_indirect(size=256)` cut (`SMOKE256`): its data
    generated on K1 into a disk cache first (launches counted), then the
    run on that cache, every stage under its graph and recorded as
    `entry_phase` records the entries' (K1 launches in the physics stages,
    none in the OP stages, no K2-K5), and the eval block beside zero force.
    Returns K1's launches: data, the run's eager ones (warm-ups, captures,
    eval) and its replays' (a replay's times its steps)."""
    import io
    import shutil
    from pathlib import Path

    from pde_control_tpu_torch.experiments import curriculum, fluid2d

    c = SMOKE256
    size, n, batch = c["size"], c["n"], c["batch"]
    workdir = Path(__file__).resolve().parent / "runs/chip_smoke_smoke256"
    shutil.rmtree(workdir, ignore_errors=True)
    datadir = str(workdir / "data")
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, train, _ = fluid2d._smoke_indirect_setup(
        size, n, c["num_train"], c["num_val"], 1.0, datadir, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    data = _counts()
    rollouts = -(-c["num_train"] // batch) + -(-c["num_val"] // batch)
    want_k1 = rollouts * (c["warmup"] + n)
    print(f"data: {c['num_train']} + {c['num_val']} trajectories of {n + 1} "
          f"frames at {size}^2 ({rollouts} rollouts of {batch}, "
          f"{c['warmup'] + n} unfused steps each) in {seconds:.2f} s, "
          f"{data['K1']} K1 launches [{card}]")
    if data["K1"] != want_k1 or any(v for k, v in data.items() if k != "K1"):
        raise AssertionError(f"data generation: launches {data}, expected "
                             f"{want_k1} K1 and no other")
    if not (np.isfinite(train.obs).all()
            and train.obs.shape == (c["num_train"], n + 1, size, size, 1)):
        raise AssertionError("data generation: non-finite or misshapen obs")
    stages: list = []
    original = curriculum.ControlTraining
    curriculum.ControlTraining = _stage_recorder(stages)
    _zero_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            fluid2d.run_smoke_indirect(
                str(workdir / "run"), size=size, n=n,
                iterations=c["iterations"], num_train=c["num_train"],
                num_val=c["num_val"], batch_size=batch, datadir=datadir,
                device="cuda")
    finally:
        curriculum.ControlTraining = original
    seconds = time.perf_counter() - t0
    counted = _counts()
    names = (["cfe_supervised"] + [f"op{s}_supervised" for s in
                                   sorted(curriculum.op_spans(n))]
             + [f"end_to_end_n{n}"])
    if len(stages) != len(names):
        raise AssertionError(f"run_smoke_indirect(size={size}): "
                             f"{len(stages)} stages trained")
    print(f"run_smoke_indirect(size={size}): {len(names)} stages in "
          f"{seconds:.2f} s (the data above, from the disk cache); wrappers "
          f"counted {counted} (warm-up steps, captures and the eval) [{card}]")
    graph = 0
    for stage, rec in zip(names, stages):
        res = rec["result"]
        if res.get("iterations_run") != c["iterations"] or not all(
                np.isfinite(v) for v in res.values()):
            raise AssertionError(f"{stage}: {res}")
        _print_stage(stage, rec, batch, card)
        gl = rec["graph_launches"]
        physics = rec["class"] != "op_supervised"
        if not (gl["K1"] > 0 if physics else gl["K1"] == 0) or any(
                gl[k] for k in gl if k != "K1"):
            raise AssertionError(f"{stage}: launches a replay {gl}")
        graph += gl["K1"] * rec["steps"]
    with open(workdir / "run" / "results.json") as f:
        ev = json.load(f)["eval"]
    if not all(np.all(np.isfinite(v)) for v in ev.values()):
        raise AssertionError("run_smoke_indirect(size=256): non-finite eval")
    print("eval (controlled beside zero force): " + json.dumps(
        {k: v for k, v in ev.items() if not isinstance(v, list)}))
    if counted["K1"] == 0 or any(v for k, v in counted.items() if k != "K1"):
        raise AssertionError(f"run_smoke_indirect(size={size}): {counted}")
    return dict(data=data["K1"], counted=counted["K1"], graph=graph)


def k1big_phase(card: str) -> dict:
    """K1 beyond 128² (the large layout to 153², the banded one from 154²):
    against its plain version at `K1_BANDED_SHAPES` under every plan, the
    gradient through `solve_pressure` at 256², 'auto' routed to it on the
    card, against the goldens of `make_cg_goldens_big.py`, its times at
    `K1_BANDED_TIMED`, the 256² app and the cut `run_smoke_indirect(size=
    256)`. Returns the row of the kernels' line."""
    _phase("K1 beyond 128² (banded layout)")
    from pde_control_tpu_torch.grids import Domain2D
    from pde_control_tpu_torch.ops import cuda_cg
    from pde_control_tpu_torch.physics import poisson

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 19)
    print("limits, under solve_plan's plan and under every plan the launcher "
          "takes (kernel_phase's; tol 1e-4 / 200 and 1e-5 / 500): kernel "
          "residual <= max(2*tol, 2*plain residual); max|dp|/max|p| <= "
          "100*tol; trip counts within 3 of plain; gradient max|dg|/max|g| "
          "<= 1e-3")
    errs = {(h, w): _k1_against_plain(dev, rng, h, w)["err"]
            for h, w in K1_BANDED_SHAPES}
    n = APP256["size"]
    domain = Domain2D.create(n, n, obstacle_mask=_plate(n), device=dev)
    div = torch.tensor(rng.normal(size=(BATCH, n, n)), dtype=torch.float32,
                       device=dev)
    if poisson._pick_backend("auto", div, domain) != "cuda":
        raise AssertionError(f"'auto' does not route {n}x{n} with obstacles "
                             "on the card to K1")
    w = torch.tensor(rng.normal(size=(BATCH, n, n)), dtype=torch.float32,
                     device=dev)
    grads = {}
    for backend in ("cuda", "pcg"):
        d = div.clone().requires_grad_(True)
        before = cuda_cg.LAUNCHES
        p = poisson.solve_pressure(d, domain, tol=1e-6, maxiter=500,
                                   backend=backend)
        (p * w).sum().backward()
        if (cuda_cg.LAUNCHES - before) != (2 if backend == "cuda" else 0):
            raise AssertionError(f"solve_pressure({backend!r}): "
                                 f"{cuda_cg.LAUNCHES - before} K1 launches")
        grads[backend] = d.grad
    g_err = float((grads["cuda"] - grads["pcg"]).abs().max()
                  / grads["pcg"].abs().max())
    print(f"{n}x{n} grad of sum(w*p) through solve_pressure, 'cuda' (2 K1) "
          f"against 'pcg': max|dg|/max|g| {g_err:.3e}")
    if g_err > 1e-3:
        raise AssertionError(f"gradient through the kernel differs: {g_err:.3e}")
    # max|dp| at the timed grid's checks (256²) and against the goldens.
    err = max(errs[(n, n)], cg_golden_files_check(dev, CG_GOLDENS_BIG),
              cg_closed_golden_check(dev))
    times = {m: _k1_times(card, dev, rng, m) for m in K1_BANDED_TIMED}
    app = app256_phase(card)
    run = smoke256_run(card)
    t = times[n]
    row = {"name": "pcg_pressure_solve_banded", "route": "cuda",
           "source": "pde_control_tpu_torch/csrc/pcg.cu",
           "replaces": "pde_control_tpu/ops/pallas_cg.py:180",
           "launches": app["first"], "max_abs_err": err,
           **{key: float(np.mean([t[s][key] for s in ("cold", "warm")]))
              for key in ("ms", "plain_ms", "bound_ms")},
           "bound_by": t["warm"]["bound_by"], "library_ms": None,
           "pcg_route_ms": float(np.mean([t[s]["pcg_ms"]
                                          for s in ("cold", "warm")])),
           "plan": t["plan"], "app256_graph_launches": app["graph"],
           "app256_ms": app["ms"], "smoke256_data_launches": run["data"],
           "smoke256_launches": run["counted"],
           "smoke256_graph_launches": run["graph"]}
    for m, tm in times.items():
        row.update({f"{s}_{key}_{m}x{BATCH}": tm[s][key] for s in ("cold", "warm")
                    for key in ("ms", "plain_ms", "pcg_ms", "bound_ms", "trips")})
    return row


# ------------------------------------ K2/K3 beyond 128² (banded layout)

# K2's and K3's grids beyond 128², closed with the plate, batch 8: 129²
# (both in the large layout), 153² and 154² (both banded: K2 from 146², K3
# from 152²), bands of unequal rows (192², 227²), the last square where K2
# takes C = 8 beside 16 (224²) and the first where it takes 16 alone
# (225²), the Pallas fluid gate's square edge and the slice's grid (236²),
# the non-square grids 96×320 and 320×96, and the gate's edges: 64 rows
# (64×600, both banded, 4 rows a rank under C = 16), 8 rows (8×990: K2
# large, K3 banded) and 8 columns (430×8, both large). The three edges
# are open boxes (`FUSED_BIG_OPEN`): in a closed one the spectral
# preconditioner's lowest mode along the long side (1/λ ~ 4e4 to 1e5)
# amplifies fp32 rounding so far that the solves stall, in the plain
# version as in K1: at 8×990 most run all 500 trips
# at tol 1e-6, at 64×600 and 430×8 a cold solve of some samples stops
# after 4–16 trips on the 4× rule where the others take ~185 and 12, and
# on the card K1 itself is then 0.52 (C = 4) to 0.004 (C = 16) of max|p|
# from the plain version at 64×600. That leaves nothing to hold the
# kernels to; open, every solve converges (8–101 trips).
FUSED_BANDED_SHAPES = [(129, 129), (153, 153), (154, 154), (192, 192),
                       (224, 224), (225, 225), (227, 227), (236, 236),
                       (96, 320), (320, 96), (64, 600), (8, 990), (430, 8)]
FUSED_BIG_OPEN = {(64, 600), (8, 990), (430, 8)}
# Trip counts beyond 128² agree within 3 or this share of the reference's:
# at tol 1e-6 the residual of these systems is near fp32's floor when the
# solve stops, and rounding then sets the stopping trip (at 192² zero
# velocity, 46 trips, the kernel under C = 16 stopped 4 from the plain
# version with outputs 1e-5 apart; against the JAX package's CG at 64×625,
# ~210 trips, the plain version stops 13 apart).
FUSED_BIG_TRIPS = 0.1
# The timed grids (batch 8, warm, force, tol 1e-4 / 200): each kernel on
# both sides of its crossing into the banded layout (K2 145² / 146², K3
# 151² / 152²), where the work hardly differs, then 192² and the gate's
# edge, 236²; and the slice's app: the largest square of the gate that its
# 3-level U-nets take (236 = 4 · 59, so their third level's pooling and
# upsampling give 60 rows against 59, in the JAX package's nets as in the
# port's; 232 = 8 · 29).
FUSED_BANDED_TIMED = (145, 146, 151, 152, 192, 236)
APP_BANDED = 232
# `scripts/make_fused_goldens_big.py`'s golden: 236² and 64×625, batch 1.
FUSED_BIG_GOLDEN = "tests/goldens/fused_step_big.npz"


def fusedbig_phase(card: str) -> list:
    """K2 and K3 beyond 128² (the large layout to 145² and 151², the
    banded one beyond): against their plain versions at
    `FUSED_BANDED_SHAPES` under every plan, in every case of
    `FUSED_CASES`, at `fused_kernel_phase`'s tol 1e-6 / 500; against
    `FUSED_BIG_GOLDEN`; their times at `FUSED_BANDED_TIMED`; the 232² app
    fused against unfused (K1, banded too). Returns the rows of the
    kernels' line."""
    _phase("K2/K3 beyond 128² (banded)")
    from pathlib import Path

    from pde_control_tpu_torch.ops import cuda_cg, cuda_fluid

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 20)
    print("limits, under the plans and every plan the launchers take, each "
          "twice for the same bits (fused_kernel_phase's, tol 1e-6 / 500): "
          "each K2 output max|d|/max|ref| <= 1e-4, each K3 cotangent <= "
          "1e-3, the non-finite cells the plain version's; trip counts "
          f"within 3 or {FUSED_BIG_TRIPS:.0%} of the reference's, whichever "
          "is more (against the golden too)")
    err = {"fwd": 0.0, "bwd": 0.0}
    for h, w in FUSED_BANDED_SHAPES:
        _fused_against_plain(dev, rng, h, w, err, trips_frac=FUSED_BIG_TRIPS,
                             closed=(h, w) not in FUSED_BIG_OPEN)
    z = np.load(Path(__file__).resolve().parent / FUSED_BIG_GOLDEN)
    for h, w in json.loads(str(z["config"]))["grids"]:
        golden = fused_golden_check(dev, FUSED_BIG_GOLDEN, h, w, f"{h}x{w}",
                                    FUSED_BIG_TRIPS)
        for key in err:
            err[key] = max(err[key], golden[key])
    times = {n: _fused_times(card, dev, rng, n) for n in FUSED_BANDED_TIMED}
    k, n = FUSED_STEP["max_shift"], APP_BANDED
    if (cuda_fluid.fwd_layout(n, n),
            cuda_fluid.bwd_layout(n, n, k)) != (cuda_cg.BANDED,) * 2:
        raise AssertionError(f"{n}² is not banded for K2 and K3")
    print(f"{n}x{n} app: K2 and K3 in the banded layout, the unfused app's "
          f"K1 in the {cuda_cg.LAYOUT_NAMES[cuda_cg.layout(n, n)]}")
    app = fused_app_phase(card, n, seqs=("staggered",), eager=False)
    rows = []
    for i, (name, key, where, line) in enumerate((
            ("fused_step_forward_banded", "K2", "fwd", 482),
            ("fused_step_backward_banded", "K3", "bwd", 516))):
        t = times[FUSED_BANDED_TIMED[-1]][i]
        row = {"name": name, "route": "cuda",
               "source": "pde_control_tpu_torch/csrc/fused_step.cu",
               "replaces": f"pde_control_tpu/ops/pallas_fluid.py:{line}",
               "launches": app["first"][key], "max_abs_err": err[where],
               **{f: t[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by")},
               "library_ms": None, "graph_ms": t["graph_ms"],
               "trips": t["trips"], "plan": t["plan"],
               f"app{n}_graph_launches": app["staggered"][key],
               f"app{n}_ms": app["staggered_ms"]}
        for side, tn in times.items():
            row.update({f"{f}_{side}x{BATCH}": tn[i][f] for f in (
                "ms", "graph_ms", "plain_ms", "bound_ms", "trips", "rest_ms",
                "us_per_trip")})
        rows.append(row)
    return rows


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


def config_conv_check(dev, rng, err: dict, label: str, keys) -> None:
    """K4 (forward, dX) and K5 against their plain versions at a config's
    conv shapes `keys`, under the wrappers' plan and every plan `fwd_plans`
    and `dw_plans` list: y and dX within 1e-2 of max|ref|, dW within 2e-2."""
    from pde_control_tpu_torch.ops import cuda_conv

    for key in keys:
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
                    raise AssertionError(f"{label} {key} {d} {plan}: max|d|/"
                                         f"max|ref| {diff / scale:.3e} > {limit}")
            rels[d] = f"{rels[d]:.2e} ({len(plans)} plans)"
        print(f"{label} {b}x{h}x{w} {cin}->{cout} against plain, worst over "
              f"every plan: " + ", ".join(f"{d} {v}" for d, v in rels.items()))


def conv_kernel_phase(card: str, shapes: dict, config_shapes: dict) -> dict:
    """K4 (forward and dX) and K5 (dW) against their plain versions, and db
    as `_Conv3x3` computes it, at every conv shape of the conv path's first
    iteration (and under every plan at config 4's CFE shapes and at the
    shapes of configs 3 and 5 the main path does not reach,
    `config_shapes`: label → shapes); then each direction's time per launch beside its plain
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
    config_conv_check(dev, rng, err, "config 4", CONFIG4_CONV_SHAPES)
    for label, keys in config_shapes.items():
        config_conv_check(dev, rng, err, label, keys)
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
    `conv_impl='cuda'`: of its `conv_impl='pallas'`), on the card:
    `profile_bench.make_app`."""
    from pde_control_tpu_torch.experiments import profile_bench

    return profile_bench.make_app(H, N, BATCH, "cuda", fused=fused,
                                  conv_impl=conv_impl, backend=backend,
                                  sequence_class=sequence_class, **train)


def make_batch(seed: int = SEED) -> dict:
    """`__graft_entry__._make_batch(64, 16, 8)`."""
    from pde_control_tpu_torch.experiments import profile_bench

    return profile_bench.make_batch(H, N, BATCH, seed)


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


# The JAX package's first iteration of the main path (64², n=16, batch 8,
# 'pcg' on the CPU), written by scripts/make_main_path_golden.py.
GOLDEN_64 = "tests/goldens/main_path_64.npz"
GOLDEN_PARAM_SEED = 21


def golden_params(shapes: dict) -> dict:
    """The golden's weights, {"net/module path/kernel|bias": float32 array}
    in flax's layout, shaped as `shapes` says: each kernel N(0, 1/fan_in)
    (flax's default lecun-normal scale), each bias 0, drawn from
    `np.random.default_rng(GOLDEN_PARAM_SEED)` leaf by leaf in sorted order;
    then the CFE's output layer Conv_4 as `perturb_cfe` sets it. The main
    path's nets hold 3.0 M parameters, 12 MB in float32: the golden keeps
    the seed and a digest instead."""
    rng = np.random.default_rng(GOLDEN_PARAM_SEED)
    out = {}
    for path in sorted(shapes):
        shape = tuple(shapes[path])
        if path.endswith("/kernel"):
            out[path] = (rng.normal(size=shape)
                         / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        else:
            out[path] = np.zeros(shape, np.float32)
    out["CFE/Conv_4/kernel"] = (0.05 * np.random.default_rng(3).normal(
        size=shapes["CFE/Conv_4/kernel"])).astype(np.float32)
    return out


def digest(arrays: dict) -> str:
    """sha256 of float32 arrays' bytes in sorted order of their keys."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k], np.float32).tobytes())
    return h.hexdigest()


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def load_golden() -> dict:
    """The golden's numbers: loss, each net's gradient norm and the mean
    trips of the warm forward and cold backward solves, by case ('bf16',
    'fp32' nets), and its seeds and digests."""
    from pathlib import Path

    z = np.load(Path(__file__).resolve().parent / GOLDEN_64)
    return dict(json.loads(str(z["config"])))


def _nets_in(app, dtype) -> None:
    """Sets every net's compute dtype: the `dtype` of each of its modules,
    which `models/nets.py` reads in their forward passes."""
    for module in app.nets.modules():
        if hasattr(module, "dtype"):
            module.dtype = dtype


# Each first iteration `golden_first` ran in this process, by (device,
# fused, conv_impl, case): the conv path's bf16 gradient is held against
# the unfused path's fp32 one, and the CPU tests share their runs.
_FIRST: dict = {}


def golden_first(golden: dict, device: str, fused: str, conv_impl: str,
                 case: str) -> dict:
    """The main path's first iteration on `device` (on the CPU the kernels'
    plain versions), on the golden's weights (loaded through
    `params_from_flax`) and batch, with the nets in the golden case's dtype
    ('bf16' or 'fp32'): {'loss', 'norms' (each net's gradient norm),
    'grads' (every gradient leaf, float32 numpy in flax's layout, keyed
    "net/module path/kernel|bias" as the golden's weights), 'trips' (each
    solve's trip counts by 'warm' and 'cold': K1 on the unfused path, K2 /
    K3 on the fused ones)}. Runs once a process for each path and case."""
    from pde_control_tpu_torch.experiments import profile_bench
    from pde_control_tpu_torch.ops import cuda_cg, cuda_fluid
    from pde_control_tpu_torch.utils.convert import params_from_flax, params_to_flax

    key = (device, fused, conv_impl, case)
    if key in _FIRST:
        return _FIRST[key]
    # 'cuda': K1 (its plain version on the CPU), as 'auto' takes on the card.
    app = profile_bench.make_app(H, N, BATCH, device, fused=fused,
                                 conv_impl=conv_impl, backend="cuda")
    _nets_in(app, {"bf16": torch.bfloat16, "fp32": torch.float32}[case])
    shapes = {k: v.shape for k, v in _flat(params_to_flax(app.state_dicts())).items()}
    params = golden_params(shapes)
    batch = make_batch(golden["seed"])
    for what, got, want in (("weights", digest(params), golden["params_sha256"]),
                            ("batch", digest(batch), golden["batch_sha256"])):
        if got != want:
            raise AssertionError(f"the golden's {what} drawn here differ from "
                                 "the ones it was written with (numpy's draws?)")
    app.load_params(params_from_flax(_nest(params)))
    trips = {"warm": [], "cold": []}
    if fused == "cuda":
        patched = [(cuda_fluid, name, _record_trips(cuda_fluid, name, trips[k]))
                   for name, k in (("fused_step_forward", "warm"),
                                   ("fused_step_backward", "cold"))]
    else:
        patched = [(cuda_cg, "pressure_solve", _record_solves(trips))]
    try:
        metrics = app.compute_gradients(app.to_batch(batch))
    finally:
        for module, name, fn in patched:
            setattr(module, name, fn)
    grads = _flat(params_to_flax(
        {n: {k: p.grad for k, p in net.named_parameters()}
         for n, net in app.nets.items()}))
    _FIRST[key] = dict(loss=float(metrics["loss"]), norms=_grad_norms(app),
                       grads=grads, trips=trips)
    return _FIRST[key]


# The JAX package's bf16 error and fp32 gradient direction on the golden's
# first iteration (scripts/make_main_path_golden.py): by net and kind of
# leaf, bf16_dist = ||g_bf16 - g_fp32|| / ||g_fp32||; by net, the fp32
# gradient's projections on SKETCH_DIRECTIONS directions of ±1, and how far
# they move, over each net's norm, when the JAX package's own solves are
# tightened from tol 1e-4 to 1e-6 (the sketch's spread).
GOLDEN_GRADS_64 = "tests/goldens/main_path_64_grads.npz"
SKETCH_SEED, SKETCH_DIRECTIONS = 22, 16
# A path's bf16 gradient may part from its fp32 one by no more than the
# JAX package's does from its own: the limit per net and kind.
BF16_DIST_SCALE, BF16_DIST_SLACK = 1.25, 1e-3
# Two fp32 gradients each carry up to the JAX package's own spread: the
# sketch's limit is a floor plus this many times the largest spread.
SKETCH_SPREAD_SCALE = 2.0


def load_golden_grads() -> dict:
    """`GOLDEN_GRADS_64`'s config: `bf16_dist` {net: {kernel, bias}},
    `fp32_sketch` {net: [SKETCH_DIRECTIONS floats]}, `fp32_norms` {net},
    `fp32_sketch_spread` {net}, `sketch_seed`, `directions`."""
    from pathlib import Path

    z = np.load(Path(__file__).resolve().parent / GOLDEN_GRADS_64)
    return dict(json.loads(str(z["config"])))


def rel_dist(got: dict, ref: dict, group) -> dict:
    """{group(path): ||got - ref|| / ||ref||} over the leaves of each group
    together, in float64."""
    num, den = {}, {}
    for path, r in ref.items():
        g, r = np.asarray(got[path], np.float64), np.asarray(r, np.float64)
        k = group(path)
        num[k] = num.get(k, 0.0) + float(np.sum((g - r) ** 2))
        den[k] = den.get(k, 0.0) + float(np.sum(r ** 2))
    return {k: float(np.sqrt(num[k] / den[k])) for k in sorted(num)}


def bf16_dist(g16: dict, g32: dict) -> dict:
    """{net: {'kernel': d, 'bias': d}}, d = ||g16 - g32|| / ||g32|| over all
    of the net's leaves of that kind."""
    out: dict = {}
    flat = rel_dist(g16, g32, lambda p: (p.split("/")[0], p.rsplit("/", 1)[1]))
    for (net, kind), d in flat.items():
        out.setdefault(net, {})[kind] = d
    return out


def grad_sketch(grads: dict, seed: int = SKETCH_SEED,
                directions: int = SKETCH_DIRECTIONS) -> dict:
    """{net: [d_j · g, j < directions]}: each net's gradient projected on
    ±1 directions, drawn from `np.random.default_rng(seed)` leaf by leaf in
    sorted order of the leaves' paths, as `golden_params` draws them (so
    two trees pair leaf for leaf only in flax's layout)."""
    rng = np.random.default_rng(seed)
    out: dict = {}
    for path in sorted(grads):
        g = np.asarray(grads[path], np.float64).ravel()
        signs = rng.integers(0, 2, size=(directions, g.size), dtype=np.int8)
        net = path.split("/")[0]
        out[net] = out.get(net, 0.0) + (2.0 * signs - 1.0) @ g
    return {net: v.tolist() for net, v in out.items()}


def bf16_grads_check(label: str, g16: dict, g32: dict, ref: dict) -> dict:
    """The path's bf16 gradient against an fp32 one on the same weights
    and batch: bf16_dist per net and kind within BF16_DIST_SCALE × the
    JAX package's own + BF16_DIST_SLACK. Prints each figure beside its
    limit; returns the distances."""
    dist, bad = bf16_dist(g16, g32), []
    for net, kinds in sorted(ref["bf16_dist"].items()):
        for kind, want in sorted(kinds.items()):
            limit = BF16_DIST_SCALE * want + BF16_DIST_SLACK
            got = dist[net][kind]
            print(f"{label} bf16_dist {net} {kind}: {got:.4e} limit "
                  f"{limit:.4e} (JAX package {want:.4e})")
            if not got <= limit:
                bad.append(f"{net} {kind} {got:.4e} > {limit:.4e}")
    if bad:
        raise AssertionError(f"{label}: bf16 gradients farther from fp32 "
                             f"than the JAX package's: {bad}")
    return dist


def sketch_check(label: str, g32: dict, ref: dict, floor: float) -> float:
    """The path's fp32 gradient projected as the JAX package's was: each
    net's projections within `floor` + SKETCH_SPREAD_SCALE × the largest
    spread of the JAX package's own sketch (its fp32 gradient moves by up
    to that, over each net's norm, when its solves are tightened from tol
    1e-4 to 1e-6), of that net's fp32 gradient norm. Returns the largest
    such error."""
    got = grad_sketch(g32, ref["sketch_seed"], ref["directions"])
    limit = floor + SKETCH_SPREAD_SCALE * max(ref["fp32_sketch_spread"].values())
    worst = 0.0
    for net, want in sorted(ref["fp32_sketch"].items()):
        err = float(np.max(np.abs(np.subtract(got[net], want)))
                    / ref["fp32_norms"][net])
        worst = max(worst, err)
        print(f"{label} fp32 sketch {net}: max|d·(g - g_JAX)| / ||g_JAX|| "
              f"{err:.3e} limit {limit:.3e} (JAX package's own spread "
              f"{ref['fp32_sketch_spread'][net]:.3e})")
        if not err <= limit:
            raise AssertionError(f"{label}: {net}'s fp32 gradient parts "
                                 f"from the JAX package's ({err:.3e})")
    return worst


def golden_check(label: str, golden: dict, fused: str,
                 conv_impl: str = "xla") -> None:
    """The path's first iteration against the JAX package's. With fp32
    nets: the loss within 1e-3 relative, each net's gradient norm within
    2e-2 (`_compare_first`) and its gradient's sketch within 1e-4 of each
    net's norm beyond twice the JAX package's own spread (`sketch_check`).
    With the main path's bf16 nets: the loss within 1e-3, and the
    gradient's distance from the fp32 one on the same path within 1.25 ×
    the JAX package's own + 1e-3, per net and kind of leaf
    (`bf16_grads_check`): two implementations of bf16 do not agree with
    each other to 2e-2, and the JAX package's bias gradients on the CPU are
    summed in bf16, so each is held to its own fp32 gradient. K4/K5 take
    bf16 alone: the conv path's bf16 gradient is held against the unfused
    path's fp32 one. The bf16 gradient norms and the bf16 run's trip means
    are printed beside the golden's."""
    grads_golden = load_golden_grads()
    bf16 = golden_first(golden, "cuda", fused, conv_impl, "bf16")
    loss, norms, trips = bf16["loss"], bf16["norms"], bf16["trips"]
    ref = golden["cases"]["bf16"]
    means = {k: float(torch.cat(v).float().mean()) for k, v in trips.items()}
    print(f"{label} on the golden (bf16 nets): trip means warm {means['warm']:.2f}"
          f" over {len(trips['warm'])} solves, cold {means['cold']:.2f} over "
          f"{len(trips['cold'])}; the JAX package's CG {ref['trips_warm_mean']:.2f}"
          f" over {N}, {ref['trips_cold_mean']:.2f} over {ref['cold_solves']}")
    print(f"first iteration loss: {label}, bf16 nets, {loss:.7e} JAX golden "
          f"{ref['loss']:.7e}; grad norms relative to the golden's: "
          f"{ {k: round(norms[k] / ref['grad_norms'][k] - 1, 4) for k in norms} }")
    if abs(loss - ref["loss"]) > 1e-3 * abs(ref["loss"]):
        raise AssertionError(f"{label}: bf16 first-iteration loss differs from "
                             "the JAX golden")
    if conv_impl == "cuda":
        fp32 = golden_first(golden, "cuda", "auto", "xla", "fp32")
        bf16_grads_check(f"{label} (against the unfused path's fp32)",
                         bf16["grads"], fp32["grads"], grads_golden)
        return
    fp32 = golden_first(golden, "cuda", fused, conv_impl, "fp32")
    ref = golden["cases"]["fp32"]
    _compare_first(f"{label}, fp32 nets, vs the JAX golden",
                   (fp32["loss"], fp32["norms"]),
                   (ref["loss"], ref["grad_norms"]))
    sketch_check(label, fp32["grads"], grads_golden, 1e-4)
    bf16_grads_check(label, bf16["grads"], fp32["grads"], grads_golden)


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


def _record_solves(trips: dict):
    """Wraps `cuda_cg.pressure_solve` (K1) so that each call appends its
    trip counts to `trips['warm']` or `trips['cold']`, by whether it had a
    guess; returns the original."""
    from pde_control_tpu_torch.ops import cuda_cg

    solve = cuda_cg.pressure_solve

    def recording(*args, **kw):
        p, it = solve(*args, **kw)
        trips["warm" if kw.get("x0") is not None else "cold"].append(it)
        return p, it

    cuda_cg.pressure_solve = recording
    return solve


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


def main_path_phase(card: str, batch: dict, first: dict, golden: dict) -> dict:
    _phase("main path, unfused (K1)")
    from pde_control_tpu_torch.ops import cuda_cg

    _compare_first("K1", first["auto"], first["pcg"])
    golden_check("K1", golden, "auto")
    app = make_app("auto")
    trips = {"warm": [], "cold": []}
    solve = _record_solves(trips)
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


def fused_path_phase(card: str, batch: dict, first: dict, golden: dict) -> dict:
    _phase("main path, fused (K2 / K3)")
    from pde_control_tpu_torch.ops import cuda_fluid

    _compare_first("fused", first["fused"], first["auto"])
    golden_check("fused", golden, "cuda")
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


def conv_path_phase(card: str, batch: dict, first: dict, shapes: dict,
                    golden: dict) -> dict:
    _phase("main path, fused, conv kernels (K2 / K3 / K4 / K5)")
    _compare_first("conv", first["conv"], first["fused"])
    golden_check("conv", golden, "cuda", "cuda")
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
# Steps a `progress_multi` call where this script times or compares one
# (the entries' own calls take 8).
K_MULTI = 4


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


# BASELINE configs 3, 4 and 5 through `run_curriculum`, each at full width
# and depth and cut in counts only: trajectories, iterations a stage (a
# multiple of the K steps of a progress_multi call) and the autosave
# interval. Data on the default route (K1), training on K2-K5.
#   3: shape transition: 64², n=16, batch 8, the direct two-channel force,
#      CFE 32-64-64-32 (the default for control='direct'), OP U-nets base
#      16 / 3 levels, maxiter 200 (the reference: 256 + 32 trajectories,
#      500 iterations a stage);
#   4: indirect smoke control: 64², n=16, batch 8, CFE 48-96-96-48 with the
#      inflow channel, U-nets base 16 / 3 levels, maxiter 200, the obstacle
#      course of `default_obstacles` (256 + 32, 500);
#   5: natural-flow reconstruction: 64², n=128, batch 8, dt 0.5, blobs, the
#      staged horizons 32 -> 64 -> 128 with frames 32/64/96/128, CFE
#      32-64-64-32, U-nets base 16 / 3 levels (OP2 ... OP128), maxiter 200
#      (128 + 16, 300).
# `warmup`: natural steps of the generator before frame 0.
CONFIGS = {
    3: dict(task="shape transition", size=64, n=16, batch=8, num_train=64,
            num_val=16, iterations=16, steps_per_call=8, autosave_every=8,
            warmup=0),
    4: dict(task="indirect smoke control", size=64, n=16, batch=8,
            num_train=64, num_val=16, iterations=16, steps_per_call=8,
            autosave_every=8, warmup=8),
    5: dict(task="natural flow, n = 128", size=64, n=128, batch=8,
            num_train=16, num_val=8, iterations=8, steps_per_call=4,
            autosave_every=4, warmup=0),
}


def _config_task(number: int, datadir: str):
    """Config `number`'s (pde, train, val) on the conv route (K2-K5), the
    data from the disk cache under `datadir` or generated by the unfused
    step with its pressure solve on K1, and its entry's CurriculumConfig
    with `CONFIGS`' counts."""
    from pde_control_tpu_torch.experiments import fluid2d
    from pde_control_tpu_torch.experiments.curriculum import CurriculumConfig

    c = CONFIGS[number]
    args = (c["size"], c["n"], c["num_train"], c["num_val"])
    routes = dict(device="cuda", fused="cuda", conv_impl="cuda")
    # Configs 3 and 5 have no obstacles, where the default route solves the
    # pressure exactly by the spectral method (the JAX package's choice) and
    # the fused kernels refuse: 'cuda' puts it on K1 (PCG at tol 1e-4) for
    # the data and the unfused reference, and lets K2/K3 train.
    kernel_solve = dict(routes, pressure_backend="cuda")
    counts = dict(n=c["n"], batch_size=c["batch"], seed=0, grad_clip=1.0,
                  cfe_iterations=c["iterations"], op_iterations=c["iterations"],
                  e2e_iterations=c["iterations"],
                  steps_per_call=c["steps_per_call"],
                  autosave_every=c["autosave_every"])
    if number == 3:
        task = fluid2d._shape_transition_setup(*args, datadir, **kernel_solve)
        ccfg = CurriculumConfig(force_reg=1e-5, **counts)
    elif number == 4:
        task = fluid2d._smoke_indirect_setup(*args, 1.0, datadir, **routes)
        ccfg = CurriculumConfig(cfe_lr=1e-3, op_lr=1e-3, e2e_lr=1e-4,
                                force_reg=3e-5, **counts)
    else:
        task = fluid2d._natural_flow_setup(*args, datadir, **kernel_solve)
        ccfg = CurriculumConfig(e2e_lr=1e-4, e2e_stage_ns=(32, 64, 128),
                                e2e_obs_frames=(32, 64, 96, 128),
                                force_reg=1e-5, **counts)
    return task, ccfg


@contextlib.contextmanager
def _cg_trips(captured_only: bool):
    """Patches `physics/poisson.py :: cg` so that each call (with
    `captured_only`, each call made while a CUDA graph is being captured)
    appends (whether it was warm-started, its per-sample trip counts as a
    device tensor) to the yielded list. A captured call's counts are the
    graph's own tensor: each replay writes it."""
    from pde_control_tpu_torch.physics import poisson

    cg, trips = poisson.cg, []

    def recording(*args, **kw):
        x, t = cg(*args, **kw, return_iters=True)
        if not captured_only or torch.cuda.is_current_stream_capturing():
            trips.append((kw.get("x0") is not None, t))
        return x

    poisson.cg = recording
    try:
        yield trips
    finally:
        poisson.cg = cg


def _graph_nodes(graph) -> int:
    """The nodes of a captured step's kept cudaGraph_t (`cuGraphGetNodes`
    of libcuda; a stream capture of the step makes no child graphs)."""
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if rc:
        raise RuntimeError(f"cuGraphGetNodes returned {rc}")
    return n.value


def _capture_text(rec: dict) -> str:
    return (f"capture {rec['capture_s']:.2f} s, instantiate "
            f"{rec['instantiate_s']:.2f} s, {rec['nodes']} graph nodes")


def _stage_recorder(stages: list):
    """A `ControlTraining` that records, for each stage it trains: each
    `progress_multi` call's device time (CUDA events) and the launches the
    wrappers counted in it, the captured step's launches, the time of the
    warm-up steps and the capture, the stage's peak and reserved memory,
    and its trained parameters; and that reads each autosave back with
    `load_training_state`, which must give the live parameters and
    optimizer tree bit for bit."""
    from pde_control_tpu_torch.control.training import (
        GRAPH_WARMUP_STEPS,
        ControlTraining,
    )
    from pde_control_tpu_torch.utils.checkpoint import (
        _leaves,
        load_training_state,
    )

    class Recorded(ControlTraining):
        def train(self, iterations, **kw):
            torch.cuda.synchronize()
            rec = {"stage": ",".join(self.trainable_networks),
                   "class": self.sequence_class, "n": self.n, "calls": [],
                   "autosaves": 0, "reserved_before": torch.cuda.memory_reserved()}
            stages.append(rec)
            self._rec = rec
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = super().train(iterations, **kw)
            torch.cuda.synchronize()
            # The last replay's CG trip counts, read from the captured
            # solves' counters (the plated 3D task; none elsewhere).
            trips, rec["trips"] = rec.pop("cg_trips", []), {}
            for label, warm in (("warm", True), ("cold", False)):
                got = [t for w, t in trips if w == warm]
                if got:
                    rec["trips"][label] = torch.stack(got).cpu()
            rec.update(seconds=time.perf_counter() - t0, result=out,
                       graph_launches=dict(self.graph_launches),
                       steps=self.step_count,
                       peak=torch.cuda.max_memory_allocated(),
                       reserved=torch.cuda.memory_reserved(),
                       params={name: {k: v.detach().cpu().clone()
                                      for k, v in net.state_dict().items()}
                               for name, net in self.nets.items()})
            return out

        def _step_graph(self, batches):
            known = len(self._graphs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _cg_trips(captured_only=True) as trips:
                out = super()._step_graph(batches)
            torch.cuda.synchronize()
            if len(self._graphs) > known:
                self._rec.update(capture_s=out.capture_s,
                                 instantiate_s=out.instantiate_s,
                                 nodes=_graph_nodes(out.graph),
                                 warmup_capture_s=time.perf_counter() - t0,
                                 cg_trips=trips,
                                 replay_start=torch.cuda.Event(
                                     enable_timing=True))
                self._rec["replay_start"].record()
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
            call = {"k": k, "ms": start.elapsed_time(end),
                    "replay_only": captured}
            if not captured:  # the replays after the capture, alone
                call["replay_ms"] = self._rec.pop(
                    "replay_start").elapsed_time(end)
            self._rec["calls"].append(call)
            return out

        def autosave(self, directory):
            super().autosave(directory)
            live = self._opt_state()
            params, tree, step = load_training_state(
                directory, self.state_dicts(), live)
            got, want = dict(_leaves(tree)), dict(_leaves(live))
            same = step == self.step_count and set(got) == set(want) and all(
                torch.equal(got[k], torch.from_numpy(np.array(want[k])))
                for k in want) and all(
                torch.equal(params[name][k], v.detach().cpu())
                for name, sd in self.state_dicts().items()
                for k, v in sd.items())
            if not same:
                raise AssertionError(f"{self._rec['stage']}: the autosave at "
                                     f"step {self.step_count} does not read "
                                     "back bit for bit")
            self._rec["autosaves"] += 1
            self._rec["autosave_leaves"] = len(want)

    return Recorded


def config_phase(card: str, number: int, conv_shapes: dict | None = None
                 ) -> dict:
    """BASELINE config `number` (`CONFIGS`) through the port's entry
    points: the datasets generated on the default route (K1) into a disk
    cache, a first CFE-stage iteration on the conv route against the
    default route, `run_curriculum` on K2-K5 (each mid-stage autosave read
    back bit for bit, `opt_state.msgpack` in the JAX package's layout
    included), the data again from the cache, `run_curriculum(resume=True)`
    on the same workdir (every stage skipped, the same eval block bit for
    bit), and the saved `CFE.msgpack` read back. With `conv_shapes`, the
    conv shapes of the curriculum's K4/K5 launches are added to it. Returns
    the launches the wrappers counted in the phase, by kernel, those of
    the captured steps times their replays, and the task."""
    c = CONFIGS[number]
    _phase(f"config {number} ({c['task']}) through run_curriculum")
    import shutil
    from pathlib import Path

    from pde_control_tpu_torch import ControlTraining, IncompressibleFluidPDE
    from pde_control_tpu_torch.experiments import curriculum
    from pde_control_tpu_torch.ops import cuda_conv
    from pde_control_tpu_torch.utils.checkpoint import load_network

    workdir = Path(__file__).resolve().parent / f"runs/chip_smoke_config{number}"
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
        out = _config_task(number, datadir)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _counts()
        add_counts()
        return out, seconds, launches

    ((pde, train, val), ccfg), seconds, launches = setup()
    rollouts = -(-c["num_train"] // 8) + -(-c["num_val"] // 8)
    steps = c["warmup"] + c["n"]
    print(f"data: {c['num_train']} + {c['num_val']} trajectories of "
          f"{c['n'] + 1} frames at {c['size']}^2 ({rollouts} rollouts of 8, "
          f"{steps} unfused steps each, pressure on K1) in {seconds:.2f} s, "
          f"{launches['K1']} K1 launches; written to the disk cache [{card}]")
    if launches["K1"] != rollouts * steps:
        raise AssertionError(f"data generation: {launches['K1']} K1 launches, "
                             f"expected {rollouts * steps}")
    if not (np.isfinite(train.obs).all() and train.obs.shape == (
            c["num_train"], c["n"] + 1, c["size"], c["size"], 1)):
        raise AssertionError("data generation: non-finite or misshapen obs")

    # The first CFE-stage iteration, conv route against the default route.
    batch = train.take(np.arange(c["batch"]))
    default_pde = IncompressibleFluidPDE(
        pde.domain, dataclasses.replace(pde.cfg, fused="auto"),
        control=pde.control, with_inflow=pde.with_inflow,
        unet_levels=pde.unet_levels, cfe_features=pde.cfe_features,
        op_base_features=pde.op_base_features)
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
    _compare_first(f"config {number} CFE stage, conv route (K2-K5) against "
                   "K1 + cuDNN", first["conv"], first["default"])

    stages: list = []
    original = curriculum.ControlTraining
    curriculum.ControlTraining = _stage_recorder(stages)
    originals = (_record_conv_shapes(conv_shapes) if conv_shapes is not None
                 else {})
    try:
        _zero_counts()
        t0 = time.perf_counter()
        results = curriculum.run_curriculum(pde, ccfg, train, val, str(workdir))
        seconds = time.perf_counter() - t0
        add_counts()
        for d, fn in originals.items():
            setattr(cuda_conv, f"conv3x3_{d}", fn)
        originals = {}
        print(f"run_curriculum: {len(stages)} stages in {seconds:.2f} s; "
              f"wrappers counted {_counts()} (data generation not included; "
              f"captures, warm-up steps, renders and the eval) [{card}]")
        ((pde2, train2, val2), _), seconds2, launches2 = setup()
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
        for d, fn in originals.items():
            setattr(cuda_conv, f"conv3x3_{d}", fn)

    stage_ns = ccfg.e2e_stage_ns or (c["n"],)
    names = ["cfe_supervised"] + [f"op{s}_supervised" for s in
                                  sorted(curriculum.op_spans(c["n"]))] + [
        f"end_to_end_n{n_k}" for n_k in stage_ns]
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
        if rec["autosaves"] != c["iterations"] // c["autosave_every"]:
            raise AssertionError(f"{name}: {rec['autosaves']} autosaves read back")
        ms = sum(cl["ms"] for cl in replays) / sum(cl["k"] for cl in replays)
        gl = rec["graph_launches"]
        physics = rec["class"] != "op_supervised"
        need = ["K4 fwd", "K4 dX", "K5"] + (["K2", "K3"] if physics else [])
        if any(gl[k] <= 0 for k in need) or gl["K1"] != 0 or (
                not physics and gl["K2"] + gl["K3"] != 0) or (
                physics and gl["K2"] != rec["n"]):
            raise AssertionError(f"{name}: launches a replay {gl}")
        rec["ms"] = ms
        pool = max(pool, rec["reserved"] - rec["reserved_before"])
        print(f"stage {name} ({rec['class']}, n={rec['n']}, trains "
              f"{rec['stage']}): {rec['steps']} steps in {rec['seconds']:.2f} s;"
              f" warm-up and capture {rec['warmup_capture_s']:.2f} s "
              f"({_capture_text(rec)}); under the graph {ms:.3f} ms a step, "
              f"{rec['n'] * c['batch'] / (ms / 1e3):.1f} steps/s (n x batch a "
              f"second); launches a replay {gl}, x {rec['steps']} steps = "
              f"{ {k: v * rec['steps'] for k, v in gl.items()} }; peak "
              f"{rec['peak'] / 2**20:.1f} MiB, reserved "
              f"{rec['reserved_before'] / 2**20:.1f} -> "
              f"{rec['reserved'] / 2**20:.1f} MiB; {rec['autosaves']} autosaves "
              f"read back ({rec['autosave_leaves']} optimizer arrays and the "
              f"networks bit for bit); loss {res['loss']:.6e} [{card}]")
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
    print("eval (controlled beside zero force): " + json.dumps(
        {k: v for k, v in ev.items() if not isinstance(v, list)}))
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
                      for k in phase_counts},
            "pde": pde, "train": train, "workdir": workdir}


def refined_128_phase(card: str, config5: dict) -> None:
    """One `progress_multi` of K = 2 at n = 128 with the 'refined' class on
    config 5's e2e app (every net trainable, restored from its
    ckpt_final), then a second one timed by CUDA events: the recursion's
    127 OP calls and 128 steps captured as one graph. Checks the launches
    a replay and finite losses; prints the capture's seconds, ms a step,
    peak and reserved memory."""
    _phase("config 5: the refined class at n = 128 under progress_multi")
    from pde_control_tpu_torch import ControlTraining
    from pde_control_tpu_torch.experiments.curriculum import op_spans

    n, k = 128, 2
    app = ControlTraining(
        n, config5["pde"], dataset=config5["train"], batch_size=BATCH,
        trainable_networks=("CFE",) + tuple(f"OP{s}" for s in op_spans(n)),
        sequence_class="refined", obs_loss_frames=(32, 64, 96, 128),
        force_reg=1e-5, learning_rate=1e-4, grad_clip=1.0,
        lr_schedule="cosine", decay_steps=2 * k, seed=0,
        restore=str(config5["workdir"] / "ckpt_final")).prepare()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = app.progress_multi(app.to_batch(app.sample_batches(k)))
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    batches = app.to_batch(app.sample_batches(k))
    _zero_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    second = app.progress_multi(batches)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / k
    gl = app.graph_launches
    # The CFE's convs (config 5 keeps the default widths, CFE_FEATURES) at
    # every step and the U-net's eligible convs at each of the n - 1 OP
    # calls; no dX for the first OP call's first conv, fed by data.
    fwd = n * (len(app.pde.cfe_features or CFE_FEATURES) + 1) + (n - 1) * (
        5 * app.pde.unet_levels + 2)
    want = {"K1": 0, "K2": n, "K3": n, "K4 fwd": fwd, "K4 dX": fwd - 1,
            "K5": fwd}
    losses = torch.cat([first["loss"], second["loss"]])
    if gl != want or any(_counts().values()) or not torch.isfinite(losses).all():
        raise AssertionError(f"refined n=128: launches a replay {gl} (expected "
                             f"{want}), wrappers in a replay {_counts()}, "
                             f"losses {losses.tolist()}")
    print(f"refined n=128, batch {BATCH}: warm-up, capture and {k} replays "
          f"{capture_s:.2f} s; under the graph {ms:.3f} ms a step "
          f"({n * BATCH / (ms / 1e3):.1f} n x batch steps/s); launches a "
          f"replay {gl}; peak {torch.cuda.max_memory_allocated() / 2**20:.1f} "
          f"MiB, reserved {torch.cuda.memory_reserved() / 2**20:.1f} MiB; "
          f"losses {[f'{v:.6e}' for v in losses.tolist()]} [{card}]")
    app.close()
    del app
    torch.cuda.empty_cache()


def cli_phase(card: str) -> None:
    """`python -m pde_control_tpu_torch.experiments.run shape_transition
    --iterations 2 --num-train 16 --num-val 8` on the card (the CLI's
    default device and routes), in this process: its results.json must
    hold a finite eval block equal to the one it printed."""
    _phase("the CLI: run shape_transition on the card")
    import contextlib
    import io
    import shutil
    from pathlib import Path

    from pde_control_tpu_torch.experiments import run

    workdir = Path(__file__).resolve().parent / "runs/chip_smoke_cli"
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        run.main(["shape_transition", "--iterations", "2", "--num-train", "16",
                  "--num-val", "8", "--workdir", str(workdir)])
    seconds = time.perf_counter() - t0
    with open(workdir / "results.json") as f:
        res = json.load(f)
    ev = res["eval"]
    if json.loads(out.getvalue())["eval"] != ev or not all(
            np.all(np.isfinite(v)) for v in ev.values()):
        raise AssertionError(f"CLI: eval block missing or non-finite: {ev}")
    print(f"run shape_transition --iterations 2 --num-train 16 --num-val 8: "
          f"results.json in {seconds:.2f} s, stages "
          f"{sorted(k for k in res if k.endswith(('supervised', '_n16')))}; "
          f"eval final_state_mse {ev['final_state_mse']:.6e}, zero force "
          f"{ev['zero_force_final_mse']:.6e} [{card}]")

# The 128² and 3D entries of `experiments/run.py`, each through the CLI a
# user runs (`run.main`), at the entries' grids, horizons, batches and
# widths, counts cut (full: smoke_128 256 + 32 trajectories, 1000
# iterations a stage, its fine-tune 600; smoke3d 64 + 16, 300, 600):
#   smoke_128: the indirect smoke task at 128², n=16, batch 8, CFE
#      48-96-96-48, U-nets base 16 / 3 levels, tol 1e-4 / maxiter 200;
#      the data generated on K1 (the plates) into a disk cache, every stage
#      unfused on K1 and cuDNN (`fused='auto'`, `conv_impl='xla'`, the
#      entry's routes) under its graph;
#   smoke3d: the closed 24³ box without obstacles, n=8, batch 8, direct
#      3-channel force, CFE 32-64-64-32 and U-nets base 16 / 2 levels at
#      dim=3 on cuDNN; every pressure solve the exact 3D spectral one, so
#      no K1-K5 launch;
#   smoke3d_indirect: the closed 32³ box with the plate, n=16, batch 8,
#      buoyancy-only control (CFE 32-64-64-32 with 7 input channels, the
#      inflow one of them), U-nets base 16 / 2 levels at dim=3 on cuDNN;
#      data after 6 warm-up steps; every pressure solve the spectrally
#      preconditioned 3D CG (tol 1e-4, maxiter 200, warm-started), eager
#      in the data and the evals and all 200 trips under each stage's
#      graph; no K1-K5 launch (full: 128 + 16 trajectories, 400
#      iterations a stage, its fine-tune 600).
# Each then `*_ft` from its ckpt_final with `ft_iterations` e2e iterations.
# Iterations are one progress_multi call of 8 steps a stage (the fewest the
# entries' K = 8 runs); the data is cut to 16 + 8 trajectories (the
# plated task's to 8 + 8), two batches of training and one of validation
# at most, so that the whole script keeps within its time limit.
ENTRIES = {
    "smoke_128": dict(task="indirect smoke control at 128^2", size=128, n=16,
                      batch=8, num_train=16, num_val=8, iterations=8,
                      ft_iterations=8, warmup=8),
    "smoke3d": dict(task="3D smoke control, 24^3", size=24, n=8, batch=8,
                    num_train=16, num_val=8, iterations=8, ft_iterations=8,
                    warmup=0),
    "smoke3d_indirect": dict(task="plated 3D smoke control, 32^3", size=32,
                             n=16, batch=8, num_train=8, num_val=8,
                             iterations=8, ft_iterations=8, warmup=6),
}


def _print_stage(name: str, rec: dict, batch: int, card: str) -> float:
    """One stage's line: steps, warm-up and capture, ms a step under the
    graph (over the calls that only replay; in a stage of one call, over
    that call's replays after the capture), launches a replay, peak and
    reserved memory, the loss; then, where the step holds CG solves, their
    trip counts after the last replay. Returns the ms a step."""
    replays = [cl for cl in rec["calls"] if cl["replay_only"]]
    if replays:
        ms = sum(cl["ms"] for cl in replays) / sum(cl["k"] for cl in replays)
    else:
        ms = rec["calls"][0]["replay_ms"] / rec["calls"][0]["k"]
    print(f"stage {name} ({rec['class']}, n={rec['n']}, trains {rec['stage']}):"
          f" {rec['steps']} steps in {rec['seconds']:.2f} s; warm-up and "
          f"capture {rec['warmup_capture_s']:.2f} s ({_capture_text(rec)}); "
          f"under the graph {ms:.3f} ms a step, "
          f"{rec['n'] * batch / (ms / 1e3):.1f} steps/s (n x batch a second"
          f"{'' if replays else '; the replays after the capture'}); "
          f"launches a replay {rec['graph_launches']}; peak "
          f"{rec['peak'] / 2**20:.1f} MiB, reserved "
          f"{rec['reserved_before'] / 2**20:.1f} -> "
          f"{rec['reserved'] / 2**20:.1f} MiB; loss "
          f"{rec['result']['loss']:.6e} [{card}]")
    for label, t in rec["trips"].items():
        print(f"  CG trips a solve after the last replay, {label} "
              f"({'forward' if label == 'warm' else 'backward'} solves, "
              f"{t.shape[0]} a step): mean {float(t.float().mean()):.2f}, max "
              f"{int(t.max())}; per sample, mean over the solves "
              f"{[round(v, 2) for v in t.float().mean(0).tolist()]}")
    return ms


def cg_capture_check(card: str, pde, val, batch: int) -> dict:
    """The plated task's pressure solve (`solve_pressure` on 'pcg' with its
    tol and maxiter) on the divergence of `batch` validation samples'
    post-warm-up velocities: forward warm-started from a perturbed
    solution, backward cold through the gradient of sum(w·p). Eager (the
    host-checked loop) against the same captured into a CUDA graph and
    replayed (all maxiter trips each): p, the gradient and the per-sample
    trip counts must be the same bits, or p and the gradient within 1e-6
    of their largest magnitude. Prints both times, the trips and the
    graph; returns the ms of one captured solve (half a replay)."""
    from pde_control_tpu_torch.grids3d import Staggered3D
    from pde_control_tpu_torch.physics import poisson

    domain, cfg = pde.domain, pde.cfg
    dev = domain.device
    b = val.take(np.arange(batch))
    v = domain.mask_velocity(Staggered3D(
        *(torch.as_tensor(b[k], device=dev) for k in ("vz0", "vy0", "vx0"))))
    div = v.divergence(domain.dx)
    kw = dict(tol=cfg.pressure_tol, maxiter=cfg.pressure_maxiter)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p_ref = poisson.solve_pressure(div, domain, **kw)
    x0 = p_ref + 0.01 * p_ref.std() * torch.randn(
        p_ref.shape, generator=gen, device=dev)
    w = torch.randn(div.shape, generator=gen, device=dev)

    def run(d_in):
        d = d_in.detach().clone().requires_grad_(True)
        p = poisson.solve_pressure(d, domain, x0=x0, **kw)
        (p * w).sum().backward()
        return p.detach(), d.grad

    with _cg_trips(captured_only=False) as trips:
        run(div)
        trips.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager = run(div)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        eager_trips = [t.clone() for _, t in trips]
        static = div.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run(static)
        torch.cuda.current_stream().wait_stream(side)
        trips.clear()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            captured = run(static)
        t1 = time.perf_counter()
        graph.instantiate()
        t2 = time.perf_counter()
        graph_trips = [t for _, t in trips]
    graph.replay()
    torch.cuda.synchronize()
    for label, got, want in zip(("p", "gradient"), captured, eager):
        err = float((got - want).abs().max())
        if not (torch.equal(got, want) or err <= 1e-6 * float(
                want.abs().max())):
            raise AssertionError(f"captured 3D solve: {label} differs from "
                                 f"eager by {err:.3e}")
    same = all(torch.equal(g, e) for g, e in zip(captured, eager))
    if len(graph_trips) != 2 or not all(
            torch.equal(g, e) for g, e in zip(graph_trips, eager_trips)):
        raise AssertionError(f"captured 3D solve: trips {graph_trips} against "
                             f"eager {eager_trips}")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 5
    print(f"the 3D CG ({cfg.pressure_backend} -> pcg, tol {kw['tol']:g}, "
          f"maxiter {kw['maxiter']}) at {tuple(div.shape)}, forward warm and "
          f"backward cold, captured against eager: p and gradient "
          f"{'the same bits' if same else 'within 1e-6 of their largest'}, "
          f"trips the same {[t.tolist() for t in eager_trips]}; eager "
          f"{eager_ms:.1f} ms (host clock); the captured pair: capture "
          f"{t1 - t0:.2f} s, instantiate {t2 - t1:.2f} s, "
          f"{_graph_nodes(graph)} graph nodes, replay {ms:.2f} ms "
          f"(2 x {kw['maxiter']} trips, {1e3 * ms / (2 * kw['maxiter']):.1f} "
          f"us a trip) [{card}]")
    return {"ms": ms / 2, "maxiter": kw["maxiter"]}


def entry_phase(card: str, name: str) -> dict:
    """`name` (`ENTRIES`) through `run.main`: its data generated first, into
    the disk cache (smoke_128, K1 launches counted) or, in 3D, where the
    entries have none, kept in memory and handed to the runs in place of
    their generator's; then every stage under its graph (recorded as config
    phases record them), the eval block beside zero force, then
    `{name}_ft` from the run's ckpt_final. Each stage on
    its entry's route: K1 launches in the physics stages of smoke_128 and
    in none of its OP stages; no K2-K5 launch; none at all in 3D. On the
    plated 3D task also the captured solve against eager
    (`cg_capture_check`), and in each physics stage the CG solves of the
    captured step (n warm, at least one cold), their trips after the last
    replay and their share of the step. Returns the wrappers' counts:
    data, stages (a replay's times its steps, by kernel) and the evals."""
    c = ENTRIES[name]
    _phase(f"{name} ({c['task']}) through run.py, then {name}_ft")
    import io
    import shutil
    from pathlib import Path

    from pde_control_tpu_torch.experiments import curriculum, fluid2d, run
    from pde_control_tpu_torch.experiments import smoke3d as smoke3d_exp

    workdir = Path(__file__).resolve().parent / f"runs/chip_smoke_{name}"
    shutil.rmtree(workdir, ignore_errors=True)
    datadir = str(workdir / "data")
    args = (c["size"], c["n"], c["num_train"], c["num_val"])
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if name == "smoke_128":
        pde, train, val = fluid2d._smoke_indirect_setup(*args, 1.0, datadir,
                                                        device="cuda")
    elif name == "smoke3d":
        pde, train, val = smoke3d_exp._smoke3d_setup(*args, device="cuda")
    else:
        pde, train, val = smoke3d_exp._smoke3d_indirect_setup(*args,
                                                              device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    data = _counts()
    chunk = 8 if name == "smoke_128" else 4
    rollouts = -(-c["num_train"] // chunk) + -(-c["num_val"] // chunk)
    steps = c["warmup"] + c["n"]
    want_k1 = rollouts * steps if name == "smoke_128" else 0
    spatial = (c["size"],) * (2 if name == "smoke_128" else 3)
    print(f"data: {c['num_train']} + {c['num_val']} trajectories of "
          f"{c['n'] + 1} frames at {c['size']}^{len(spatial)} ({rollouts} "
          f"rollouts of {chunk}, {steps} unfused steps each) in {seconds:.2f} s,"
          f" {data['K1']} K1 launches [{card}]")
    if data["K1"] != want_k1 or any(v for k, v in data.items() if k != "K1"):
        raise AssertionError(f"data generation: launches {data}, expected "
                             f"{want_k1} K1 and no other")
    if not (np.isfinite(train.obs).all() and train.obs.shape == (
            c["num_train"], c["n"] + 1, *spatial, 1)):
        raise AssertionError("data generation: non-finite or misshapen obs")
    solve = None
    if name == "smoke3d_indirect":
        want = {"inflow": spatial, "vz0": (c["size"] + 1,) + spatial[1:],
                "vy0": (c["size"], c["size"] + 1, c["size"]),
                "vx0": spatial[:2] + (c["size"] + 1,)}
        for key, shape in want.items():
            got = train.extras[key]
            if got.shape != (c["num_train"],) + shape or not np.isfinite(
                    got).all():
                raise AssertionError(f"data generation: {key} {got.shape}")
        solve = cg_capture_check(card, pde, val, c["batch"])

    cut = ["--num-train", str(c["num_train"]), "--num-val", str(c["num_val"])]
    generator = None
    if name == "smoke_128":
        cut += ["--datadir", datadir]
    else:  # no disk cache in 3D: the runs take these datasets, by seed
        generator = ("generate_inflow_smoke3d_dataset" if name ==
                     "smoke3d_indirect" else "generate_forced_smoke3d_dataset")
        made, generate = {0: train, 999: val}, getattr(smoke3d_exp, generator)

        def generated(domain, cfg, num, n_steps, seed=0, **kw):
            data = made[seed]
            if len(data) != num or data.obs.shape[1] != n_steps + 1:
                raise AssertionError(f"{generator}: {num}, {n_steps}, {seed}")
            return data

        setattr(smoke3d_exp, generator, generated)
    runs = {}
    original = curriculum.ControlTraining
    try:
        for label, argv in (
                (name, [name, "--iterations", str(c["iterations"])]),
                (f"{name}_ft", [f"{name}_ft", "--e2e-iterations",
                                str(c["ft_iterations"]), "--init-from",
                                str(workdir / name / "ckpt_final")])):
            stages: list = []
            curriculum.ControlTraining = _stage_recorder(stages)
            _zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as out:
                run.main(argv + cut + ["--workdir", str(workdir / label)])
            seconds = time.perf_counter() - t0
            runs[label] = dict(stages=stages, counted=_counts(),
                               seconds=seconds, printed=out.getvalue())
    finally:
        curriculum.ControlTraining = original
        if generator:
            setattr(smoke3d_exp, generator, generate)

    stage_names = {
        name: ["cfe_supervised"] + [f"op{s}_supervised" for s in
                                    sorted(curriculum.op_spans(c["n"]))]
        + [f"end_to_end_n{c['n']}"],
        f"{name}_ft": [f"end_to_end_n{c['n']}"]}
    counts = {"data": data}
    for label, r in runs.items():
        with open(workdir / label / "results.json") as f:
            res = json.load(f)
        ev = res["eval"]
        if json.loads(r["printed"])["eval"] != ev or not all(
                np.all(np.isfinite(v)) for v in ev.values()):
            raise AssertionError(f"{label}: eval block missing or non-finite")
        names = stage_names[label]
        if len(r["stages"]) != len(names):
            raise AssertionError(f"{label}: {len(r['stages'])} stages trained")
        source = "the disk cache" if name == "smoke_128" else "memory"
        print(f"run.py {label}: {len(names)} stages in {r['seconds']:.2f} s "
              f"(the data above, from {source}); wrappers "
              f"counted {r['counted']} (warm-up steps, captures and the "
              f"eval) [{card}]")
        graph = dict.fromkeys(r["counted"], 0)
        for stage, rec in zip(names, r["stages"]):
            res_s = rec["result"]
            want_it = c["ft_iterations"] if label.endswith("_ft") else c[
                "iterations"]
            if res_s.get("iterations_run") != want_it or not all(
                    np.isfinite(v) for v in res_s.values()):
                raise AssertionError(f"{label} {stage}: {res_s}")
            rec["ms"] = _print_stage(stage, rec, c["batch"], card)
            physics = rec["class"] != "op_supervised"
            if solve and physics and not (
                    len(rec["trips"].get("warm", [])) == c["n"]
                    and len(rec["trips"].get("cold", []))):
                got = {k: len(t) for k, t in rec["trips"].items()}
                raise AssertionError(f"{label} {stage}: captured CG solves "
                                     f"{got}")
            if solve and rec["trips"]:
                solves = sum(t.shape[0] for t in rec["trips"].values())
                print(f"  the CG's share of this step: {solves} solves x "
                      f"{solve['ms']:.3f} ms (all {solve['maxiter']} trips, "
                      f"by the solve's own graph) = {solves * solve['ms']:.1f}"
                      f" ms of {rec['ms']:.1f} ms "
                      f"({100 * solves * solve['ms'] / rec['ms']:.1f}%)")
            gl = rec["graph_launches"]
            k1 = gl["K1"] > 0 if physics and name == "smoke_128" else gl["K1"] == 0
            if not k1 or any(gl[k] for k in gl if k != "K1"):
                raise AssertionError(f"{label} {stage}: launches a replay {gl}")
            for k, v in gl.items():
                graph[k] += v * rec["steps"]
        print(f"{label} eval (controlled beside zero force): " + json.dumps(
            {k: v for k, v in ev.items() if not isinstance(v, list)}))
        counts[label] = dict(counted=r["counted"], graph=graph)
    return counts


# The out-of-distribution evals (`experiments/generalize.py`) on the
# checkpoints that configs 3 and 4 leave in `runs/chip_smoke_config{3,4}`, at
# the entries' sizes (64², n=16, config 4's CFE 48-96-96-48, OP16 ... OP2,
# the horizon rows 24 and 32). Cut: `num_val`, 32 trajectories a row in the
# entries, to 8 (`scripts/quality_torch.py --ood` runs the 32).
OOD = dict(num_val=8)
# `results.json` keys of the JAX package's entries at full size.
OOD_KEYS = {
    "generalize_shapes": {"init_from", "protocol", "shapes", "shapes_chain",
                          "crosses", "crosses_chain", "rings", "rings_chain",
                          "shapes_worst_idx", "rings_worst_idx"},
    "generalize_smoke": {"init_from", "in_dist", "in_dist_chain",
                         "obstacles_ood", "inflow_shifted", "horizon_24",
                         "horizon_32"},
}


def _smoke_eval_k1(n: int, num_val: int, horizons=(24, 32)) -> int:
    """K1 launches of `generalize_smoke`: each row generates its data in
    rollouts of 8 (8 warm-up steps and nh steps each) and evaluates its
    chunks of 16 trajectories, controlled and at zero force (nh steps
    each): four rows at n, one at each horizon."""
    rollouts = -(-num_val // 8)
    chunks = max(num_val // 16, 1)
    return sum(rollouts * (8 + nh) + chunks * 2 * nh
               for nh in [n] * 4 + list(horizons))


def generalize_phase(card: str, configs: dict) -> dict:
    """`generalize_shapes` from config 3's ckpt_final and `generalize_smoke`
    from config 4's, on the card's default route: every row finite and
    printed, `results.json` with the JAX module's keys and the worst-sample
    PNGs, K1's launches (the obstacle courses' solves) as many as the rows'
    rollouts take. Returns the wrappers' counts."""
    _phase("the OOD evals: generalize_shapes (config 3) and generalize_smoke "
           "(config 4)")
    import contextlib
    import io
    import shutil

    from pde_control_tpu_torch.experiments import generalize

    counted = dict.fromkeys(_counts(), 0)
    for name, number in (("generalize_shapes", 3), ("generalize_smoke", 4)):
        src = configs[number]["workdir"]
        workdir = src.parent / f"chip_smoke_{name}"
        shutil.rmtree(workdir, ignore_errors=True)
        _zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = getattr(generalize, name)(
                str(workdir), init_from=str(src / "ckpt_final"),
                num_val=OOD["num_val"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _counts()
        for k, v in launches.items():
            counted[k] += v
        with open(workdir / "results.json") as f:
            on_disk = json.load(f)
        if set(on_disk) != OOD_KEYS[name]:
            raise AssertionError(f"{name}: results.json keys {sorted(on_disk)}")
        rows = [k for k, v in res.items() if isinstance(v, dict)]
        for tag in rows:
            r = res[tag]
            vals = (r["final_state_mse"], r["zero_force_final_mse"],
                    r["ratio_vs_zero_force"])
            if not all(np.isfinite(vals)) or r["eval_samples"] != OOD["num_val"]:
                raise AssertionError(f"{name} {tag}: {r}")
            scheme = r.get("scheme", "chain_final" if tag.endswith("_chain")
                           else "staggered")
            print(f"{name} {tag} ({scheme}): mse {vals[0]:.6e}, zero-force "
                  f"mse {vals[1]:.6e}, ratio {vals[2]:.4f} over "
                  f"{r['eval_samples']} trajectories")
        pngs = sorted(p.name for p in workdir.glob("worst_*.png"))
        if name == "generalize_shapes":
            want = [f"worst_{t}_{r}.png" for t in ("rings", "shapes")
                    for r in range(4)]
            if pngs != want:
                raise AssertionError(f"{name}: worst PNGs {pngs}")
            print(f"{name}: worst samples shapes {res['shapes_worst_idx']}, "
                  f"rings {res['rings_worst_idx']}; {len(pngs)} PNGs")
            expect_k1 = 0  # no obstacles: the exact spectral solve
        else:
            expect_k1 = _smoke_eval_k1(N, OOD["num_val"])
        if launches["K1"] != expect_k1 or any(
                v for k, v in launches.items() if k != "K1"):
            raise AssertionError(f"{name}: wrappers counted {launches}, "
                                 f"expected K1 {expect_k1} and no other")
        print(f"{name}: {len(rows)} rows in {seconds:.2f} s, wrappers counted "
              f"{launches}, peak {torch.cuda.max_memory_allocated() / 2**20:.1f}"
              f" MiB [{card}]")
    return counted


def render_phase(card: str, configs: dict) -> None:
    """`render_rollout.render('smoke_indirect')` on config 4's run: the
    four strips and finite MSEs."""
    _phase("render_rollout smoke_indirect on config 4's run")
    import contextlib
    import io

    from pde_control_tpu_torch.experiments import render_rollout

    workdir = configs[4]["workdir"]
    _zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = render_rollout.render("smoke_indirect", str(workdir))
    seconds = time.perf_counter() - t0
    pngs = {name: workdir / "renders" / f"{name}.png" for name in
            ("controlled", "ground_truth", "zero_force", "force_magnitude")}
    missing = [n for n, p in pngs.items()
               if not p.exists() or p.stat().st_size == 0]
    if missing or not all(np.isfinite(list(res.values()))):
        raise AssertionError(f"render: missing {missing} or MSEs {res}")
    print(out.getvalue().splitlines()[0])
    print(f"render_rollout: {len(pngs)} PNGs in {seconds:.2f} s ("
          + ", ".join(f"{n} {p.stat().st_size} B" for n, p in pngs.items())
          + f"), wrappers counted {_counts()} [{card}]")


def native_gather_phase(card: str, configs: dict) -> None:
    """Config 4's data cache read by the native gather (`load_dataset`)
    and by numpy (`np.load` a file, `np.stack`): the same bits; both
    times, best of 3, after the library's build."""
    _phase("the native gather on config 4's data cache")
    from pde_control_tpu_torch.data import native_loader
    from pde_control_tpu_torch.data.scene import Scene, load_dataset

    t0 = time.perf_counter()
    native_loader.get_lib()
    build_s = time.perf_counter() - t0
    for split in ("train", "val"):
        root = str(configs[4]["workdir"] / "data" / split)
        with open(f"{root}/manifest.json") as f:
            m = json.load(f)

        def numpy_path():
            obs = np.stack([np.stack([np.load(Scene.at(root, i).frame_path(
                "obs", t, "npy")) for t in range(m["frames"])])
                for i in range(m["num"])])
            return obs, {k: np.stack([np.load(Scene.at(root, i).frame_path(
                k, 0, "npy")) for i in range(m["num"])]) for k in m["extras"]}

        def native_path():
            ds = load_dataset(root, m["num"], m["frames"], m["extras"])
            return ds.obs, ds.extras

        times, out = {"native": [], "numpy": []}, {}
        for _ in range(3):
            for label, fn in (("native", native_path), ("numpy", numpy_path)):
                t0 = time.perf_counter()
                out[label] = fn()
                times[label].append(time.perf_counter() - t0)
        (obs, ex), (obs_np, ex_np) = out["native"], out["numpy"]
        if obs.tobytes() != obs_np.tobytes() or set(ex) != set(ex_np) or any(
                ex[k].tobytes() != ex_np[k].tobytes() for k in ex_np):
            raise AssertionError(f"native gather: {split} differs from numpy")
        nbytes = obs.nbytes + sum(v.nbytes for v in ex.values())
        files = m["num"] * (m["frames"] + len(m["extras"]))
        print(f"native gather, config 4 {split}: {files} files, "
              f"{nbytes / 2**20:.1f} MiB, the same bits as numpy; native "
              f"{1e3 * min(times['native']):.1f} ms, numpy "
              f"{1e3 * min(times['numpy']):.1f} ms (best of 3, host clock; "
              f"library build or load {build_s:.2f} s) [{card}]")


def gather_step_phase(card: str) -> None:
    """One unfused 64² step with `advection_mode='gather'` on the card
    against the same step on the CPU, the pressure solve on K1 and on its
    plain version (tol 1e-6, maxiter 500): the state, the loss and the
    gradients with respect to vy, vx, rho and the force."""
    _phase("gather-mode advection: one 64² step, the card against the CPU")
    from pde_control_tpu_torch import Domain2D, FluidConfig, FluidState
    from pde_control_tpu_torch.grids import Staggered2D
    from pde_control_tpu_torch.physics.fluid import fluid_step

    rng = np.random.default_rng(SEED + 13)
    arrays = [0.8 * rng.normal(size=(BATCH, H + 1, H)),
              0.8 * rng.normal(size=(BATCH, H, H + 1)),
              rng.uniform(0, 1, size=(BATCH, H, H)),
              0.02 * rng.normal(size=(BATCH, H + 1, H)),
              0.02 * rng.normal(size=(BATCH, H, H + 1))]
    weights = [rng.normal(size=s) for s in ((BATCH, H + 1, H),
                                            (BATCH, H, H + 1), (BATCH, H, H),
                                            (BATCH, H, H))]
    cfg = FluidConfig(dt=1.0, buoyancy=0.08, pressure_tol=1e-6,
                      pressure_maxiter=500, warm_start_pressure=True,
                      advection_mode="gather", pressure_backend="cuda")

    def run(dev):
        domain = Domain2D.create(H, H, obstacle_mask=_plate(H), device=dev)
        args = [torch.tensor(a, dtype=torch.float32, device=dev,
                             requires_grad=True) for a in arrays]
        vy, vx, rho, fy, fx = args
        s = fluid_step(FluidState(Staggered2D(vy, vx), rho,
                                  pressure=torch.zeros_like(rho)),
                       domain, cfg, force=Staggered2D(fy, fx))
        outs = [s.velocity.vy, s.velocity.vx, s.density, s.pressure]
        loss = sum((torch.tensor(w, dtype=torch.float32, device=dev) * o).sum()
                   for w, o in zip(weights, outs))
        loss.backward()
        return ([o.detach().cpu() for o in outs] + [loss.detach().cpu()],
                [a.grad.cpu() for a in args])

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_state, card_grads = run("cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counts()
    cpu_state, cpu_grads = run("cpu")
    state, _, _ = _agree("gather step state", card_state, cpu_state,
                         ("vy", "vx", "rho", "p", "loss"), 1e-4, False)
    grads, _, _ = _agree("gather step gradients", card_grads, cpu_grads,
                         ("g_vy", "g_vx", "g_rho", "g_fy", "g_fx"), 1e-3, False)
    if launches["K1"] < 1:
        raise AssertionError(f"gather step: wrappers counted {launches}")
    print(f"gather step at {H}x{H}, batch {BATCH} (the plate, velocity "
          f"0.8 N(0,1)), the card against the CPU, max|d|/max|ref| (limits "
          f"1e-4 state and loss, 1e-3 gradients): "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in {**state, **grads}.items()})}"
          f"; first call on the card {seconds:.2f} s, wrappers counted "
          f"{launches} [{card}]")


def conv_impls_phase(card: str) -> None:
    """The main path's CFE (bf16, CFE_FEATURES, output layer perturbed) at
    64² x 8, forward and backward, under 'patches', 'shifted' and 'im2col'
    against 'xla' (cuDNN): the output and every parameter gradient within
    2e-2 of max|ref|; the forward and forward + backward times of each
    beside cuDNN's (CUDA events over a host loop)."""
    _phase("the conv impls 'patches', 'shifted', 'im2col' against cuDNN")
    from pde_control_tpu_torch.models.nets import CFENet

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    nets = {"xla": CFENet(5, 1, features=CFE_FEATURES, dtype=torch.bfloat16,
                          generator=gen)}
    w = nets["xla"].Conv_4.weight
    with torch.no_grad():
        w.copy_(0.05 * torch.randn(w.shape, generator=gen))
    for impl in ("patches", "shifted", "im2col"):
        nets[impl] = CFENet(5, 1, features=CFE_FEATURES, dtype=torch.bfloat16,
                            conv_impl=impl)
        nets[impl].load_state_dict(nets["xla"].state_dict())
    x = torch.randn((BATCH, H, H, 5), generator=gen).to(dev)
    g = torch.randn((BATCH, H, H, 1), generator=gen).to(dev)
    results = {}
    for impl, net in nets.items():
        net.to(dev)

        def fwd_bwd(net=net):
            for p in net.parameters():
                p.grad = None
            y = net(x)
            y.backward(g)
            return y

        y = fwd_bwd().detach().float()
        grads = {k: p.grad.float().clone() for k, p in net.named_parameters()}
        with torch.no_grad():
            fwd_ms = _time_ms(lambda net=net: net(x), 20)
        results[impl] = (y, grads, fwd_ms, _time_ms(fwd_bwd, 10))
    y_ref, g_ref, fwd_ref, both_ref = results["xla"]
    for impl in ("patches", "shifted", "im2col"):
        y, grads, fwd_ms, both_ms = results[impl]
        rels = {"y": float((y - y_ref).abs().max() / y_ref.abs().max())}
        rels.update({k: float((grads[k] - v).abs().max() / v.abs().max())
                     for k, v in g_ref.items()})
        worst = max(rels, key=rels.get)
        if not rels[worst] <= 2e-2:
            raise AssertionError(f"conv_impl={impl}: {worst} max|d|/max|ref| "
                                 f"{rels[worst]:.3e} > 2e-2")
        print(f"conv_impl={impl} against xla, CFE {CFE_FEATURES} at {H}x{H}x"
              f"{BATCH}: max|d|/max|ref| y {rels['y']:.3e}, worst of y and "
              f"the gradients {worst} {rels[worst]:.3e} (limit 2e-2); forward "
              f"{fwd_ms:.3f} ms (cuDNN {fwd_ref:.3f}), forward + backward "
              f"{both_ms:.3f} ms (cuDNN {both_ref:.3f}) [{card}]")


def profile_bench_phase(card: str) -> None:
    """`profile_bench` once at 64², n=16, batch 8 on the card."""
    _phase("profile_bench at 64², n=16, batch 8")
    from pde_control_tpu_torch.experiments import profile_bench

    res = profile_bench.run("cuda", blocks=2, inner=2)
    bad = [k for k, v in res.items() if k != "flops_per_step"
           and not v["ms"] > 0]
    if bad:
        raise AssertionError(f"profile_bench: phases without a time: {bad}")
    print("\n".join(profile_bench.lines(res, card)))


# BASELINE configs 1-2 (Burgers, `experiments/burgers.py`): N=32, dx 1/32,
# dt 0.03, viscosity 0.01, periodic; n=32, batch 32; the CFE 32-64-64-32
# and the U-nets OP32 ... OP2 (3 levels, base 16), fp32 nets with TF32 off.
# Cut: the iterations, 2000 (config 1) and 1000 (config 2) a stage in the
# reference, to `iterations` at K = 8 (the entries' steps a call), and
# the validation set, 128 trajectories, to `num_val`, one batch (the
# training set keeps the reference's 1024; `scripts/quality_torch.py`
# runs both at full counts). `eager_steps`: eager steps timed after each
# stage, its state restored after them.
BURGERS = dict(n=32, batch=32, num_train=1024, num_val=32, iterations=16,
               eager_steps=3)
# The adjoint (`control/adjoint.py`) on the 32-trajectory eval prefix, at
# config 1's size (lr 0.1, force_reg 1e-4; 500 iterations in the
# reference) and at compare_smoke's 64², n=16 with the plates and inflow
# (lr 0.5, force_reg 3e-4; 300), cut to `burgers_iterations` and
# `smoke_iterations`; eager runs of `eager_iterations`. Then
# `compare_burgers` and `compare_smoke` at `compare_iterations` a stage
# (1000 and 500 in the reference), compare_smoke's adjoint row at
# `smoke_adjoint` iterations (300), compare_burgers' sets cut to
# `burgers_train` + `burgers_val` trajectories (1024 + 128; its
# 500-iteration adjoint row as the reference's), compare_smoke's to
# `smoke_train` + `smoke_val` (256 + 32), and the smoke adjoint's batch to
# `smoke_val` trajectories (32). `scripts/quality_torch.py
# compare_burgers` runs the reference's counts.
ADJOINT = dict(burgers_iterations=100, smoke_iterations=20,
               eager_iterations=3, compare_iterations=8, smoke_adjoint=20,
               burgers_train=64, burgers_val=32, smoke_train=32, smoke_val=8)


def _device_ops(fn) -> tuple[int, float, float]:
    """Runs `fn` once under `torch.profiler`, tracing the device only: its
    device operations, the device's busy ms (the union of their
    intervals) and the wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in device):
        if e > end:
            busy += e - max(s, end)
            end = e
    return len(device), busy / 1e3, wall


def _ops_text(ops: tuple) -> str:
    n, busy, wall = ops
    if not n:
        return "device operations not measured (the profiler saw none)"
    return (f"{n} device operations, busy {busy:.3f} of {wall:.3f} ms under "
            f"the profiler ({100 * busy / wall:.1f}%)")


def _burgers_recorder(stages: list):
    """`_stage_recorder`'s ControlTraining, which after each stage also
    times `eager_steps` eager steps (CUDA events, after one untimed),
    profiles one graph replay (and, in the CFE and e2e stages, one eager
    step), and then restores the stage's state (parameters, moments,
    counters, step count)."""
    recorded = _stage_recorder(stages)

    class Timed(recorded):
        def train(self, iterations, **kw):
            out = super().train(iterations, **kw)
            rec = self._rec
            t0 = time.perf_counter()
            saved, steps = [t.clone() for t in self._state()], self.step_count
            batch = self.to_batch(self.dataset.sample(
                np.random.default_rng(0), self.batch_size))
            self.progress(batch)
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(BURGERS["eager_steps"]):
                self.progress(batch)
            end.record()
            torch.cuda.synchronize()
            rec["eager_ms"] = start.elapsed_time(end) / BURGERS["eager_steps"]
            graph = next(iter(self._graphs.values())).graph
            rec["graph_ops"] = _device_ops(graph.replay)
            if self.sequence_class != "op_supervised":
                rec["eager_ops"] = _device_ops(lambda: self.progress(batch))
            for t, s in zip(self._state(), saved):
                t.copy_(s)
            self.step_count = steps
            rec["timing_s"] = time.perf_counter() - t0
            return out

    return Timed


def _fp32_first(label: str, got: tuple, ref: tuple) -> None:
    """fp32 tolerances: the loss within 1e-4 relative, each parameter's
    gradient within 1e-3 relative norm error and not zero."""
    (loss_g, grads_g), (loss_r, grads_r) = got, ref
    errs = {k: float((grads_g[k] - g).norm() / g.norm()) if float(g.norm())
            else float("inf") for k, g in grads_r.items()}
    print(f"{label}: loss {loss_g:.7e} against {loss_r:.7e}; gradient norm "
          f"{float(torch.sqrt(sum((g ** 2).sum() for g in grads_g.values()))):.6e}"
          f" against {float(torch.sqrt(sum((g ** 2).sum() for g in grads_r.values()))):.6e};"
          f" worst relative gradient error {max(errs.values()):.3e} "
          f"({max(errs, key=errs.get)})")
    if abs(loss_g - loss_r) > 1e-4 * abs(loss_r) or max(errs.values()) > 1e-3:
        raise AssertionError(f"{label}: beyond fp32 tolerance {errs}")


def burgers_phase(card: str) -> dict:
    """BASELINE configs 1 and 2 (`BURGERS`) through the port's entry points
    on the card: the data generated there, the first CFE-stage iteration
    against the CPU at fp32 tolerance (CFE output layer perturbed), config
    1's `run_chain_supervised` and config 2's `run_hierarchical`
    (`run_curriculum`), every stage under `progress_multi`'s graph, with
    ms a step under the graph and eager, device operations a replay, peak
    memory and the eval blocks. No kernel of K1-K5 may launch. Returns the
    datasets."""
    _phase("configs 1-2 (Burgers) through run_curriculum")
    import shutil
    from pathlib import Path

    from pde_control_tpu_torch import ControlTraining
    from pde_control_tpu_torch.control.pde_burgers import BurgersPDE
    from pde_control_tpu_torch.experiments import burgers, curriculum

    c, n = BURGERS, BURGERS["n"]
    workdir = Path(__file__).resolve().parent / "runs/chip_smoke_burgers"
    shutil.rmtree(workdir, ignore_errors=True)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    pde = BurgersPDE(burgers.BURGERS_CFG)
    if pde.device.type != "cuda" or torch.backends.cudnn.allow_tf32:
        raise AssertionError("BurgersPDE: not on the card, or TF32 left on")
    print(f"BurgersPDE on {pde.device}: cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32} (the fp32 nets' convs in fp32)")
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train, val = burgers.make_datasets(n, c["num_train"], c["num_val"],
                                       str(workdir / "data"))
    seconds = time.perf_counter() - t0
    if train.obs.shape != (c["num_train"], n + 1, 32, 1) or not (
            np.isfinite(train.obs).all() and np.isfinite(val.obs).all()):
        raise AssertionError("Burgers data: non-finite or misshapen obs")
    print(f"data: {c['num_train']} + {c['num_val']} trajectories of {n + 1} "
          f"frames at N=32, generated on the card in rollouts of up to 64, "
          f"{seconds:.2f} s [{card}]")

    batch = train.take(np.arange(c["batch"]))
    first, weights = {}, None
    for dev in ("cuda", "cpu"):
        app = ControlTraining(n, BurgersPDE(burgers.BURGERS_CFG, device=dev),
                              trainable_networks=("CFE",),
                              sequence_class="chain",
                              obs_loss_frames=tuple(range(1, n + 1)),
                              force_reg=1e-4, seed=0).prepare()
        if weights is None:
            w = app.nets["CFE"].Conv_4.weight
            k = 0.05 * np.random.default_rng(3).normal(size=tuple(w.shape))
            with torch.no_grad():
                w.copy_(torch.tensor(k, dtype=torch.float32))
            weights = {"CFE": {key: v.detach().cpu().clone() for key, v in
                               app.nets["CFE"].state_dict().items()}}
        app.load_params(weights)
        metrics = app.compute_gradients(app.to_batch(batch))
        first[dev] = (float(metrics["loss"]),
                      {key: p.grad.detach().cpu() for key, p in
                       app.nets["CFE"].named_parameters()})
        del app
    _fp32_first("config 1 first CFE-stage iteration, the card against the CPU",
                first["cuda"], first["cpu"])

    stages: list = []
    originals = burgers.ControlTraining, curriculum.ControlTraining
    burgers.ControlTraining = curriculum.ControlTraining = \
        _burgers_recorder(stages)
    sizes = dict(n=n, iterations=c["iterations"], num_train=c["num_train"],
                 num_val=c["num_val"], batch_size=c["batch"])
    try:
        _zero_counts()
        t0 = time.perf_counter()
        res1 = burgers.run_chain_supervised(str(workdir / "config1"), **sizes)
        t1 = time.perf_counter()
        res2 = burgers.run_hierarchical(str(workdir / "config2"), **sizes)
        t2 = time.perf_counter()
        counted = _counts()
    finally:
        burgers.ControlTraining, curriculum.ControlTraining = originals
    if any(counted.values()):
        raise AssertionError(f"the Burgers path launched kernels: {counted}")
    names = ["config 1 CFE"] + [f"config 2 {s}" for s in (
        "CFE", "OP2", "OP4", "OP8", "OP16", "OP32", "e2e")]
    if len(stages) != len(names):
        raise AssertionError(f"{len(stages)} stages trained")
    for name, rec in zip(names, stages):
        res = rec["result"]
        bad = [k for k, v in res.items() if not np.isfinite(v)]
        replays = [cl for cl in rec["calls"] if cl["replay_only"]]
        if bad or res.get("iterations_run") != c["iterations"] or not replays:
            raise AssertionError(f"{name}: non-finite {bad}, {res}, "
                                 f"calls {rec['calls']}")
        rec["ms"] = sum(cl["ms"] for cl in replays) / sum(
            cl["k"] for cl in replays)
        print(f"stage {name} ({rec['class']}, n={rec['n']}, trains "
              f"{rec['stage']}): {rec['steps']} steps in {rec['seconds']:.2f} "
              f"s; warm-up and capture {rec['warmup_capture_s']:.2f} s; "
              f"{rec['ms']:.3f} ms a step under the graph, "
              f"{rec['eager_ms']:.3f} eager ({rec['eager_ms'] / rec['ms']:.1f}x);"
              f" a replay: {_ops_text(rec['graph_ops'])}; an eager step: "
              f"{_ops_text(rec['eager_ops']) if 'eager_ops' in rec else 'not profiled'}"
              f" (eager timing and profiles "
              f"{rec['timing_s']:.2f} s); peak "
              f"{rec['peak'] / 2**20:.1f} MiB, reserved "
              f"{rec['reserved'] / 2**20:.1f} MiB; loss {res['loss']:.6e} "
              f"[{card}]")
    with open(workdir / "config2" / "results.json") as f:
        on_disk = json.load(f)
    for label, res in (("config 1", res1), ("config 2", res2)):
        ev = res["eval"]
        if not all(np.all(np.isfinite(v)) for v in ev.values()):
            raise AssertionError(f"{label}: non-finite eval block {ev}")
        print(f"{label} eval (controlled beside zero force): " + json.dumps(
            {k: v for k, v in ev.items() if not isinstance(v, list)}))
    if on_disk["eval"] != json.loads(json.dumps(res2["eval"])):
        raise AssertionError("config 2: results.json's eval block differs")
    print(f"run_chain_supervised {t1 - t0:.2f} s, run_hierarchical "
          f"{t2 - t1:.2f} s (data generation included); wrappers counted "
          f"{counted} [{card}]")
    return {"train": train, "val": val}


def _adjoint_runs(label: str, pde, batch: dict, n: int, lr: float,
                  force_reg: float, iterations: int, card: str,
                  must_fall: bool = False) -> dict:
    """`optimize_forces` on the card: its first call (warm-up, capture and
    `iterations` replays), the same call again (replays only, timed by
    CUDA events), and `eager_iterations` steps of the same program run
    eagerly (timed), whose history must match the graph's first
    iterations at rtol 1e-4. The
    wrappers' counts must be the captured step's launches times the eager
    steps, and none in a replay; with `must_fall`, the last obs_loss must
    be below the first (compare_smoke's lr 0.5 oscillates over the first
    tens of iterations). Returns one replay's launches and the times."""
    from pde_control_tpu_torch.control import adjoint

    state0, target = pde.initial_state(batch), batch["obs"][:, n]
    kw = dict(n=n, learning_rate=lr, force_reg=force_reg)

    def call(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end), time.perf_counter() - t0, _counts()

    def graph():
        return adjoint.optimize_forces(pde, state0, target,
                                       iterations=iterations, **kw)

    e = ADJOINT["eager_iterations"]
    eager = _adjoint_program(pde, batch, n, lr, force_reg, e)

    def eager_steps():
        for _ in range(e):
            eager.step()
        return dict(zip(adjoint.HISTORY_KEYS, eager.history.cpu().numpy()))

    (_, hist), _, first_s, counted = call(graph)
    program = next(p for key, p in pde._adjoint_programs.items()
                   if key[1] == iterations)
    per_replay = program.launches
    want = {k: (adjoint.GRAPH_WARMUP_STEPS + 1) * v
            for k, v in per_replay.items()}
    if counted != want:
        raise AssertionError(f"{label}: wrappers counted {counted}, expected "
                             f"{want}")
    (forces, hist2), graph_ms, _, counted = call(graph)
    if any(counted.values()):
        raise AssertionError(f"{label}: a replay ran a wrapper: {counted}")
    hist_e, eager_ms, _, counted = call(eager_steps)
    if counted != {k: e * v for k, v in per_replay.items()}:
        raise AssertionError(f"{label}: eager counts {counted}")
    for key in hist:
        # The second run replays the same graph from the same start; only
        # the atomic scatter-adds of the backward may order sums otherwise.
        if not (np.isfinite(hist[key]).all() and np.allclose(
                hist2[key], hist[key], rtol=1e-3,
                atol=1e-3 * abs(hist[key][0])) and np.allclose(
                hist_e[key], hist[key][:e], rtol=1e-4)):
            raise AssertionError(f"{label} {key}: graph {hist[key][:e]}, "
                                 f"again {hist2[key][:e]}, eager {hist_e[key]}")
    if must_fall and not hist["obs_loss"][-1] < hist["obs_loss"][0]:
        raise AssertionError(f"{label}: obs_loss did not fall {hist['obs_loss']}")
    graph_ms, eager_ms = graph_ms / iterations, eager_ms / e
    print(f"{label}: {iterations} iterations, first call (3 warm-up steps, "
          f"capture, replays) {first_s:.2f} s; {graph_ms:.3f} ms an optimizer "
          f"step under the graph, {eager_ms:.3f} eager ({eager_ms / graph_ms:.1f}x);"
          f" launches a replay {per_replay}; obs_loss "
          f"{hist['obs_loss'][0]:.6e} -> {hist['obs_loss'][-1]:.6e} (least "
          f"{hist['obs_loss'].min():.6e}), force_cost "
          f"{hist['force_cost'][-1]:.6e}; graph and eager histories agree over "
          f"the first {e} iterations (rtol 1e-4) [{card}]")
    return {"graph_ms": graph_ms, "eager_ms": eager_ms, "launches": per_replay,
            "forces": forces}


def _adjoint_program(pde, batch: dict, n: int, lr: float, force_reg: float,
                     iterations: int):
    """`optimize_forces`' program (MSE, clip 1.0) on `batch`, for eager
    steps."""
    from pde_control_tpu_torch.control import adjoint

    return adjoint._Program(pde, pde.initial_state(batch), batch["obs"][:, n],
                            n, iterations, lr, force_reg, adjoint._mse, 1.0)


def _adjoint_first(pde, batch: dict, n: int, lr: float, force_reg: float):
    """The adjoint's first iteration: its loss and the gradient's norm."""
    program = _adjoint_program(pde, batch, n, lr, force_reg, 1)
    program.step()
    return float(program.history[1, 0]), float(program.flat.grad.norm())


def adjoint_phase(card: str, burgers_data: dict) -> None:
    """`optimize_forces` on Burgers (config 1's size) and on compare_smoke's
    64², n=16 task (`ADJOINT`), each graph against eager; the smoke adjoint
    on K1 (unfused) and on K2/K3 (`fused='cuda'`), first iterations
    agreeing; then `compare_burgers` and `compare_smoke` with cut counts,
    each writing comparison.json with every row."""
    _phase("the adjoint and compare_schemes")
    import shutil
    from pathlib import Path

    from pde_control_tpu_torch import (
        Domain2D,
        FluidConfig,
        IncompressibleFluidPDE,
    )
    from pde_control_tpu_torch.control.pde_burgers import BurgersPDE
    from pde_control_tpu_torch.data.generate import (
        generate_inflow_smoke_dataset,
    )
    from pde_control_tpu_torch.experiments import burgers, compare_schemes
    from pde_control_tpu_torch.experiments.fluid2d import default_obstacles

    a = ADJOINT
    dev = torch.device("cuda")

    def on_card(b):
        return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                   device=dev) for k, v in b.items()}

    n = BURGERS["n"]
    batch = on_card(compare_schemes._eval_batch(burgers_data["val"]))
    _adjoint_runs(f"Burgers adjoint, N=32, n={n}, batch "
                  f"{batch['obs'].shape[0]}", BurgersPDE(burgers.BURGERS_CFG),
                  batch, n, 0.1, 1e-4, a["burgers_iterations"], card,
                  must_fall=True)

    # compare_smoke's task: 64², n=16, the plates, inflow; its val set.
    domain = Domain2D.create(H, H, obstacle_mask=default_obstacles(H, H),
                             device=dev)
    cfg = FluidConfig(dt=1.0, buoyancy=0.08, pressure_tol=1e-4,
                      pressure_maxiter=200, warm_start_pressure=True)
    _zero_counts()
    t0 = time.perf_counter()
    val = generate_inflow_smoke_dataset(domain, cfg, a["smoke_val"], N,
                                        seed=999, control_amplitude=0.6)
    print(f"smoke data: {a['smoke_val']} trajectories at 64^2, n={N}, on K1: "
          f"{time.perf_counter() - t0:.2f} s, {_counts()['K1']} K1 launches "
          f"[{card}]")
    batch = on_card(compare_schemes._eval_batch(val))
    kw = dict(control="buoyancy", with_inflow=True, unet_levels=3)
    unfused = IncompressibleFluidPDE(domain, cfg, **kw)
    fused = IncompressibleFluidPDE(domain, dataclasses.replace(
        cfg, fused="cuda"), **kw)
    label = f"smoke adjoint, 64^2, n={N}, batch {batch['obs'].shape[0]}"
    runs = _adjoint_runs(f"{label}, unfused (K1)", unfused, batch, N, 0.5,
                         3e-4, a["smoke_iterations"], card)
    # The backward needs a transpose solve at every step but the last: the
    # final density is advected before the last projection, so that solve
    # does not reach the loss. The step-0 force needs its gradient, as the
    # CFE's step-0 force does on the main path: 2n - 1 there and here.
    if runs["launches"]["K1"] != 2 * N - 1:
        raise AssertionError(f"{label}: {runs['launches']['K1']} K1 launches "
                             f"a replay, expected 2n - 1 = {2 * N - 1}")
    print(f"K1 a replay: {N} forward (warm) + {N - 1} transpose (cold) = "
          f"{2 * N - 1}: the last step's projection does not reach the "
          "final density, and the step-0 force takes its gradient through "
          "step 0's solve, as the CFE's force does on the main path")
    fused_runs = _adjoint_runs(f"{label}, fused (K2/K3)", fused, batch, N, 0.5,
                               3e-4, a["smoke_iterations"], card)
    fl = fused_runs["launches"]
    if (fl["K1"], fl["K2"], fl["K3"]) != (0, N, N):
        raise AssertionError(f"{label} fused: launches a replay {fl}")
    got, ref = (_adjoint_first(p, batch, N, 0.5, 3e-4)
                for p in (fused, unfused))
    print(f"{label} first iteration: obs loss {got[0]:.7e} (K2/K3) against "
          f"{ref[0]:.7e} (K1), gradient norm {got[1]:.6e} against "
          f"{ref[1]:.6e}")
    if abs(got[0] - ref[0]) > 1e-3 * abs(ref[0]) or not ref[1] > 0 or abs(
            got[1] - ref[1]) > 2e-2 * ref[1]:
        raise AssertionError(f"{label}: the routes' first iterations differ")

    root = Path(__file__).resolve().parent / "runs"
    for name, fn, extra in (
            ("compare_burgers", compare_schemes.compare_burgers,
             dict(num_train=a["burgers_train"], num_val=a["burgers_val"])),
            ("compare_smoke", compare_schemes.compare_smoke,
             dict(num_train=a["smoke_train"], num_val=a["smoke_val"],
                  adjoint_iterations=a["smoke_adjoint"]))):
        workdir = root / f"chip_smoke_{name}"
        shutil.rmtree(workdir, ignore_errors=True)
        _zero_counts()
        t0 = time.perf_counter()
        res = fn(str(workdir), iterations=a["compare_iterations"], **extra)
        seconds = time.perf_counter() - t0
        counted = _counts()
        with open(workdir / "comparison.json") as f:
            on_disk = json.load(f)
        rows = ("chain_final", "staggered", "refined", "adjoint", "zero_force")
        if on_disk != json.loads(json.dumps(res)) or not all(
                r in res and np.isfinite(res[r]["final_state_mse"])
                for r in rows):
            raise AssertionError(f"{name}: rows missing or non-finite: {res}")
        if name == "compare_smoke" and not counted["K1"] > 0:
            raise AssertionError(f"{name}: no K1 launch ({counted})")
        print(f"{name}: comparison.json in {seconds:.2f} s ("
              f"{a['compare_iterations']} iterations a stage, adjoint "
              f"{res['adjoint']['iterations']}); wrappers counted {counted}; "
              "final_state_mse / mean_abs_force: " + ", ".join(
                  f"{r} {res[r]['final_state_mse']:.4e}"
                  + (f" / {res[r]['mean_abs_force']:.4e}"
                     if "mean_abs_force" in res[r] else "") for r in rows)
              + f" [{card}]")



# ------------------------------------------------- data parallelism, spatial
# One card: DP runs as a world of one rank under NCCL (in this process,
# through a FileStore) and as two ranks on the card under gloo (eager, in
# subprocesses); the spatial splits run on a (1, 1) mesh. Multi-rank
# correctness is the CPU tests' (tests/test_torch_{mesh,spatial,
# spatial_opt,spatial3d}.py).

K_MESH = 4
GLOO_SEEDS = (SEED + 40, SEED + 41)
_DETERMINISTIC = dict(enabled=True, deterministic=True, benchmark=False,
                      allow_tf32=False)
# The spatial checks: the JAX package's check's physics at 64² with the
# plate (tests/_spatial_equality_check.py), 'spectral' without it, and its
# tolerances: loss, final state, force gradient.
SPATIAL = dict(steps=3, dt=0.5, buoyancy=0.1, tol=1e-7, maxiter=800)
SPATIAL_MODES = {"jax": ("jax", True), "pcg": ("pcg", True),
                 "pcg2": ("pcg", True), "spectral": ("spectral", False)}


@contextlib.contextmanager
def _nccl_world():
    """A world of one rank under NCCL on cuda:0, through a FileStore in a
    temporary directory; destroyed on leaving."""
    import os
    import tempfile

    import torch.distributed as dist

    tmp = tempfile.mkdtemp()
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_step(app, batch) -> tuple:
    """One step as `progress` runs it: (loss, each net's gradient norm read
    before the update, the parameters after it)."""
    metrics = app._global_metrics(app.compute_gradients(
        app._device_batch(batch)))
    norms = _grad_norms(app)
    app.apply_gradients()
    return (float(metrics["loss"]), norms,
            [t.clone() for t in app.nets.state_dict().values()])


def _same_step(label: str, a: tuple, b: tuple) -> None:
    same = (a[0] == b[0] and a[1] == b[1]
            and all(torch.equal(x, y) for x, y in zip(a[2], b[2])))
    print(f"{label}: loss {a[0]:.9e} / {b[0]:.9e}, grad norms equal "
          f"{a[1] == b[1]}, parameters equal "
          f"{all(torch.equal(x, y) for x, y in zip(a[2], b[2]))}")
    if not same:
        raise AssertionError(f"{label}: mesh=make_mesh(1) differs from "
                             "mesh=None")


def _graph_kernel_names(graph) -> dict:
    """Kernel nodes of a kept cudaGraph_t by function name
    (`cuGraphGetNodes`, `cuGraphNodeGetType`, `cuGraphKernelNodeGetParams`
    and `cuFuncGetName` of libcuda); other nodes by type."""
    cuda = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(g, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(g, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    out: dict = {}
    kind = ctypes.c_int(0)
    # CUDA_KERNEL_NODE_PARAMS_v2: func, 7 dims (4 slots), kernelParams,
    # extra, kern, ctx; padded.
    params = (ctypes.c_void_p * 16)()
    name = ctypes.c_char_p()
    named = hasattr(cuda, "cuFuncGetName") and hasattr(cuda, "cuKernelGetName")
    for node in nodes:
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        key = f"node type {kind.value}"
        if kind.value == 0:
            key = "kernel (name not read)"
            if named and not cuda.cuGraphKernelNodeGetParams_v2(
                    ctypes.c_void_p(node), params):
                rc = (cuda.cuFuncGetName(ctypes.byref(name),
                                         ctypes.c_void_p(params[0]))
                      if params[0] else
                      cuda.cuKernelGetName(ctypes.byref(name),
                                           ctypes.c_void_p(params[7])))
                if not rc and name.value:
                    key = name.value.decode()
        out[key] = out.get(key, 0) + 1
    return out


@contextlib.contextmanager
def _captured_all_reduces():
    """Patches `torch.distributed.all_reduce` so that each call made while
    a CUDA graph is captured is counted; yields the count (a list)."""
    import torch.distributed as dist

    fn, calls = dist.all_reduce, [0]

    def counting(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            calls[0] += 1
        return fn(*args, **kw)

    dist.all_reduce = counting
    try:
        yield calls
    finally:
        dist.all_reduce = fn


def mesh_phase(card: str) -> dict:
    """(a) of the "mesh" phase: `ControlTraining(mesh=make_mesh(1))` under
    NCCL against `mesh=None`, the same bits: the first iteration on each
    path, then K_MESH `progress_multi` steps under the graph on the main
    path. Returns each kernel's launches by the mesh apps alone (eager) and
    in K_MESH replays of the mesh app's graph."""
    _phase("mesh: data parallelism, a world of one rank under NCCL")
    from pde_control_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1)
    print(f"mesh {mesh.shape} rank {mesh.rank} device {mesh.device} backend "
          f"{mesh.backend}, NCCL {torch.cuda.nccl.version()}")
    batch = make_batch()
    counted = dict.fromkeys(_counts(), 0)
    with torch.backends.cudnn.flags(**_DETERMINISTIC):
        for path, config in PATHS.items():
            steps = []
            for kw in ({}, {"mesh": mesh}):
                app = make_app(*config, **kw)
                perturb_cfe(app)
                _zero_counts()
                steps.append(_mesh_step(app, batch))
                if kw:  # the mesh app's launches alone
                    counted = {k: counted[k] + v for k, v in _counts().items()}
                del app
            _same_step(f"first iteration, {path}", *steps)
        batches = _device_batches(K_MESH, SEED + 30)
        runs, apps = {}, {}
        for label, kw in (("mesh=None", {}), ("mesh", {"mesh": mesh})):
            app = apps[label] = make_app(**kw)
            perturb_cfe(app)
            _zero_counts()
            with _captured_all_reduces() as calls:
                first = app.progress_multi(batches)["loss"].clone()
            if kw:
                counted = {k: counted[k] + v for k, v in _counts().items()}
            graph = next(iter(app._graphs.values()))
            runs[label] = dict(loss=first,
                               state=[t.clone() for t in app._state()],
                               ms=[], nodes=_graph_nodes(graph.graph),
                               kinds=_graph_kernel_names(graph.graph),
                               launches=dict(app.graph_launches),
                               captured_all_reduces=calls[0])
        # Graph replays in turns (A B B A, twice): single calls of either
        # app have landed ~66 or ~79 ms a step on the same card.
        for label in ("mesh=None", "mesh", "mesh", "mesh=None") * 2:
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            apps[label].progress_multi(batches)
            end.record()
            torch.cuda.synchronize()
            runs[label]["ms"].append(start.elapsed_time(end) / K_MESH)
        del apps, app, graph
        torch.cuda.empty_cache()
    a, b = runs["mesh=None"], runs["mesh"]
    same = torch.equal(a["loss"], b["loss"]) and all(
        torch.equal(x, y) for x, y in zip(a["state"], b["state"]))
    for label, r in runs.items():
        nccl = {k: v for k, v in r["kinds"].items() if "nccl" in k.lower()}
        print(f"progress_multi({K_MESH}) {label}: ms a step under the graph "
              f"(CUDA events, 4 calls in turns) "
              f"{', '.join(f'{t:.3f}' for t in r['ms'])}, {r['nodes']} graph "
              f"nodes, "
              f"all-reduces captured {r['captured_all_reduces']}, NCCL "
              f"kernel nodes {sum(nccl.values())} {nccl} (kernel nodes whose "
              f"name was not read: "
              f"{r['kinds'].get('kernel (name not read)', 0)}), launches a replay "
              f"{r['launches']} [{card}]")
    print(f"mesh graph against mesh=None: {min(b['ms']) / min(a['ms']):.4f}x "
          f"the least ms a step, {b['nodes'] - a['nodes']:+d} nodes; losses "
          f"and state "
          f"(parameters, moments, count, counters) the same bits: {same}")
    if not same:
        raise AssertionError("the mesh graph differs from mesh=None's")
    for r in runs.values():
        if r["launches"]["K1"] != 2 * N - 1:
            raise AssertionError(f"K1 a replay {r['launches']['K1']}, "
                                 f"expected {2 * N - 1}")
    if b["captured_all_reduces"] != 3:
        raise AssertionError("the mesh step's capture made "
                             f"{b['captured_all_reduces']} all-reduces, "
                             "expected 3 (gradient, not-finite flag, metrics)")
    print(f"launches of the mesh=make_mesh(1) apps alone (first iterations "
          f"on the three paths, the graph app's warm-up and capture): "
          f"{counted}")
    missing = [k for k, v in counted.items() if not v]
    if missing:
        raise AssertionError(f"the mesh path launched no {missing}")
    return {"counted": counted, "graph": {k: K_MESH * v for k, v in
                                          runs["mesh"]["launches"].items()}}


def _gloo_steps(app) -> list:
    """(b)'s two eager `progress` steps: for each, (loss, this rank's own
    flat trainable gradient, the flat gradient the optimizer took, i.e. the
    all-reduced one under a mesh, the trainable parameters after it)."""
    out = []
    update = app.optimizer.update
    for s in GLOO_SEEDS:
        took = []
        app.optimizer.update = lambda flat, *a, **kw: (
            took.append(flat.clone()), update(flat, *a, **kw))[1]
        loss = float(app.progress(make_batch(s))["loss"])
        del app.optimizer.update
        out.append((loss, torch.cat([p.grad.reshape(-1)
                                     for p in app.trainable]).cpu(),
                    took[0].cpu(), [p.detach().cpu() for p in app.trainable]))
    return out


def _gloo_rank(rank: int, tmp: str) -> None:
    """A rank of (b): two ranks of a gloo group on cuda:0. Probes that
    gloo takes CUDA tensors for all_reduce and broadcast; then two eager
    `progress` steps of the main path on its half of the batch, and
    `progress_multi`, which must refuse. Writes its results to `tmp`."""
    import os

    import torch.distributed as dist

    from pde_control_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), 2), rank=rank, world_size=2)
    out = os.path.join(tmp, f"rank{rank}.pt")
    try:
        t = torch.full((4,), rank + 1.0, device="cuda")
        b = torch.full((4,), float(rank), device="cuda")
        dist.all_reduce(t)
        dist.broadcast(b, 0)
        probe = bool((t == 3).all() and (b == 0).all())
    except RuntimeError as e:  # the probe the phase asks for; nothing runs
        torch.save({"probe_error": repr(e)}, out)
        dist.destroy_process_group()
        return
    mesh = make_mesh(2, device="cuda:0")
    with torch.backends.cudnn.flags(**_DETERMINISTIC):
        app = make_app(mesh=mesh)
        perturb_cfe(app)
        steps = _gloo_steps(app)
    try:
        app.progress_multi(_device_batches(2, SEED))
        refused = None
    except RuntimeError as e:
        refused = str(e)
    torch.save({"probe": probe, "steps": steps, "refused": refused,
                "launches": _counts()}, out)
    dist.destroy_process_group()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖ / ‖b‖ in fp64."""
    return float((a.double() - b.double()).norm() / b.double().norm())


# (b)'s limits, steps 1 and 2, on the two half batches' step against the
# whole batch's, both with the main path's bf16 nets and K1's own plans
# (batch 4 and batch 8): the loss's relative error and ‖g_DP − g_full‖ /
# ‖g_full‖ of the all-reduced gradient. The split changes the convs'
# algorithms, so their bf16 rounding, and K1's plan; nothing else, as the
# bit-for-bit half of the check shows. About 4× this phase's H100
# readings (1.10e-5 and 2.68e-4; 5.65e-4 and 7.90e-4; PERF.md §6): step
# 2 starts from parameters that step 1's bf16 split has already moved.
GLOO_LOSS_RTOL = (5e-5, 1e-3)
GLOO_GRAD_RTOL = (3e-3, 3e-3)


def gloo_phase(card: str) -> None:
    """(b) of the "mesh" phase: two gloo ranks on the one card, each on
    its half of the batch, for two eager `progress` steps. In the first,
    rank r's gradient must be, bit for bit, the one a single-device app
    computes on half r, and the all-reduced gradient and the loss their
    mean. Against `mesh=None` on the whole batch, after each step, the loss
    must hold GLOO_LOSS_RTOL and the all-reduced gradient GLOO_GRAD_RTOL;
    the ranks' replicas must be equal. Parameters against the whole
    batch's are printed, not held: Adam's first step is lr·sign(g), so
    they compare the gradient's signs."""
    _phase("mesh: two gloo ranks on the one card")
    import os
    import tempfile

    from pde_control_tpu_torch.experiments import profile_bench

    tmp = tempfile.mkdtemp()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, __file__, "gloo-rank", str(r),
                               tmp]) for r in (0, 1)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise AssertionError(f"gloo ranks exited {rcs}")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in (0, 1)]
    if any("probe_error" in r for r in ranks):
        print(f"gloo on this card does not take CUDA tensors: "
              f"{[r.get('probe_error') for r in ranks]}; (b) left out")
        return
    for r in ranks:
        if not (r["probe"] and r["refused"] and "gloo" in r["refused"]):
            raise AssertionError(f"probe {r['probe']}, progress_multi under "
                                 f"gloo: {r['refused']!r}")
    with torch.backends.cudnn.flags(**_DETERMINISTIC):
        app = make_app()
        perturb_cfe(app)
        full = _gloo_steps(app)
        lr = app.learning_rate
        # The first step's two half batches, each on a single-device app.
        batch = make_batch(GLOO_SEEDS[0])
        half = []
        for r in (0, 1):
            app = profile_bench.make_app(H, N, BATCH // 2, "cuda")
            perturb_cfe(app)
            loss = app.progress({k: v[r * BATCH // 2:(r + 1) * BATCH // 2]
                                 for k, v in batch.items()})["loss"]
            half.append((loss.float().cpu(), torch.cat(
                [p.grad.reshape(-1) for p in app.trainable]).cpu()))
        del app
    dp = ranks[0]["steps"]
    exact = {
        "rank gradients": all(torch.equal(r["steps"][0][1], h[1])
                              for r, h in zip(ranks, half)),
        "all-reduced gradient": all(
            torch.equal(r["steps"][0][2], (half[0][1] + half[1][1]) / 2)
            for r in ranks),
        "loss": dp[0][0] == float((half[0][0] + half[1][0]) / 2),
        "replicas": all(torch.equal(x, y) for x, y in
                        zip(ranks[0]["steps"][1][3], ranks[1]["steps"][1][3])),
    }
    loss_rel = [abs(d[0] - f[0]) / abs(f[0]) for d, f in zip(dp, full)]
    grad_rel = [_rel(d[2], f[2]) for d, f in zip(dp, full)]
    total = sum(p.numel() for p in full[0][3])
    params = []
    for d, f in zip(dp, full):
        diff = [(x.double() - y.double()).abs() for x, y in zip(d[3], f[3])]
        params.append((sum(int((e > 1e-6 + 1e-4 * y.double().abs()).sum())
                           for e, y in zip(diff, f[3])),
                       max(float(e.max()) for e in diff)))
    print(f"two gloo ranks on cuda:0, 2 eager steps at {H}x{H} batch {BATCH} "
          f"(4 a rank), the main path's bf16 nets and K1's own plans. Step "
          f"1 against single-device apps on each half batch, bit for bit: "
          f"{exact}. Against mesh=None on the whole batch, steps 1 and 2: "
          f"losses {[d[0] for d in dp]} / {[f[0] for f in full]}, relative "
          f"{loss_rel} (limit {GLOO_LOSS_RTOL}); all-reduced gradient's "
          f"relative L2 error {grad_rel} (limit {GLOO_GRAD_RTOL}); "
          f"parameters beyond rtol 1e-4, atol 1e-6 (of {total}) "
          f"{[p[0] for p in params]}, max|d| {[p[1] for p in params]} (lr "
          f"{lr}; not held). Launches a rank {ranks[0]['launches']}; "
          f"progress_multi refused: {ranks[0]['refused'][:60]}…; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    if not (all(exact.values()) and all(
            e <= t for e, t in zip(loss_rel + grad_rel,
                                   GLOO_LOSS_RTOL + GLOO_GRAD_RTOL))):
        raise AssertionError("the gloo ranks differ from the half batches' "
                             "single-device step, from the whole batch's "
                             "beyond the limits, or from each other")


def mesh_cli_phase(card: str) -> None:
    """(c) of the "mesh" phase: `torchrun --nproc-per-node 1 -m
    pde_control_tpu_torch.experiments.run smoke_indirect --mesh 1` with
    the CLI phase's cut counts; rank 0's results.json holds the eval block
    it printed."""
    _phase("mesh: run smoke_indirect --mesh 1 under torchrun")
    import shutil
    from pathlib import Path

    workdir = Path(__file__).resolve().parent / "runs/chip_smoke_mesh_cli"
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "pde_control_tpu_torch.experiments.run",
         "smoke_indirect", "--mesh", "1", "--iterations", "2", "--num-train",
         "16", "--num-val", "8", "--workdir", str(workdir)],
        capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-4000:])
        raise AssertionError(f"torchrun exited {proc.returncode}")
    with open(workdir / "results.json") as f:
        res = json.load(f)
    ev = res["eval"]
    if json.loads(proc.stdout)["eval"] != ev or not all(
            np.all(np.isfinite(v)) for v in ev.values()):
        raise AssertionError(f"torchrun CLI: eval block missing or "
                             f"non-finite: {ev}")
    print(f"torchrun run smoke_indirect --mesh 1 --iterations 2 --num-train "
          f"16 --num-val 8: {seconds:.2f} s, stages "
          f"{sorted(k for k in res if k.endswith(('supervised', '_n16')))}; "
          f"eval final_state_mse {ev['final_state_mse']:.6e}, zero force "
          f"{ev['zero_force_final_mse']:.6e} [{card}]")


def _spatial_inputs(h: int, b: int) -> dict:
    rng = np.random.default_rng(SEED)
    yy, xx = np.meshgrid(np.arange(h), np.arange(h), indexing="ij")

    def blob(r):
        c = r.uniform(h * 0.2, h * 0.8, (b, 2))
        return np.exp(-((yy[None] - c[:, 0, None, None]) ** 2
                        + (xx[None] - c[:, 1, None, None]) ** 2)
                      / (0.03 * h * h)).astype(np.float32)

    arrays = dict(density=blob(rng),
                  fy=rng.normal(0, 0.05, (b, h + 1, h)).astype(np.float32),
                  fx=rng.normal(0, 0.05, (b, h, h + 1)).astype(np.float32),
                  target=blob(np.random.default_rng(SEED + 7)))
    return {k: torch.tensor(v, device="cuda") for k, v in arrays.items()}


def _rollout_grad(step, x: dict, steps: int):
    """loss = mean((final density − target)²) of `steps` steps from rest
    with the force, and the force's gradient."""
    from pde_control_tpu_torch import FluidState
    from pde_control_tpu_torch.grids import Staggered2D

    b, h, w = x["density"].shape
    fy, fx = (x[k].clone().requires_grad_() for k in ("fy", "fx"))
    state = FluidState(velocity=Staggered2D.zeros(b, h, w, device="cuda"),
                       density=x["density"])
    for _ in range(steps):
        state = step(state, Staggered2D(vy=fy, vx=fx))
    loss = torch.mean((state.density - x["target"]) ** 2)
    loss.backward()
    return loss.detach(), state, fy.grad, fx.grad


def spatial_phase(card: str) -> dict:
    """The "spatial" phase on a (1, 1) mesh: `spatial_fluid_step` at 64²
    with the plate, batch 8, in each mode ('spectral' without the plate)
    against the dense `fluid_step`, forward and gradients; the divergence
    after projection and ms a step; then `optimize_forces_spatial` as the
    JAX package's multichip gate runs it (64², n=3, 25 iterations,
    'pcg', cosine), which must improve the loss at least 2×."""
    _phase("spatial: the split step on a (1, 1) mesh")
    from pde_control_tpu_torch import (
        Domain2D,
        FluidConfig,
        FluidState,
        fluid_step,
    )
    from pde_control_tpu_torch.grids import Staggered2D
    from pde_control_tpu_torch.parallel.spatial import (
        make_mesh2d,
        spatial_fluid_step,
    )
    from pde_control_tpu_torch.parallel.spatial_opt import (
        optimize_forces_spatial,
    )

    mesh = make_mesh2d(1, 1)
    s = SPATIAL
    x = _spatial_inputs(H, BATCH)
    _zero_counts()
    print(f"limits: loss rtol 1e-5, final state rtol 1e-4 atol 1e-6, force "
          f"gradient rtol 1e-3 atol 2e-5; {s['steps']} steps from rest, "
          f"{H}x{H} batch {BATCH}, tol {s['tol']}")
    for mode, (dense_mode, plate) in SPATIAL_MODES.items():
        domain = Domain2D.create(H, H, obstacle_mask=_plate(H) if plate
                                 else None, device="cuda")
        cfgs = [FluidConfig(dt=s["dt"], buoyancy=s["buoyancy"],
                            pressure_tol=s["tol"], pressure_maxiter=s["maxiter"],
                            pressure_backend=m) for m in (mode, dense_mode)]
        sp = _rollout_grad(lambda st, f: spatial_fluid_step(
            st, domain, cfgs[0], mesh, force=f), x, s["steps"])
        de = _rollout_grad(lambda st, f: fluid_step(st, domain, cfgs[1],
                                                    force=f), x, s["steps"])
        np.testing.assert_allclose(float(sp[0]), float(de[0]), rtol=1e-5)
        for got, want in ((sp[1].density, de[1].density),
                          (sp[1].velocity.vy, de[1].velocity.vy),
                          (sp[1].velocity.vx, de[1].velocity.vx)):
            np.testing.assert_allclose(got.detach().cpu().numpy(),
                                       want.detach().cpu().numpy(),
                                       rtol=1e-4, atol=1e-6)
        for got, want in zip(sp[2:], de[2:]):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-3, atol=2e-5)
        v = sp[1].velocity
        div = float((Staggered2D(vy=v.vy.detach(), vx=v.vx.detach())
                     .divergence(domain.dx) * domain.fluid_mask).abs().max())
        state = FluidState(velocity=Staggered2D(vy=v.vy.detach(),
                                                vx=v.vx.detach()),
                           density=sp[1].density.detach())
        force = Staggered2D(vy=x["fy"], vx=x["fx"])
        times = {}
        with torch.no_grad():
            for label, fn in (("spatial", lambda: spatial_fluid_step(
                    state, domain, cfgs[0], mesh, force=force)),
                              ("dense", lambda: fluid_step(
                    state, domain, cfgs[1], force=force))):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                for _ in range(5):
                    fn()
                end.record()
                torch.cuda.synchronize()
                times[label] = (start.elapsed_time(end) / 5,
                                1e3 * (time.perf_counter() - t0) / 5)
        print(f"spatial {mode} (dense {dense_mode}, plate {plate}): loss "
              f"{float(sp[0]):.9e} / {float(de[0]):.9e}, max|div| after "
              f"projection {div:.3e}; a forward step {times['spatial'][0]:.3f}"
              f" ms (host {times['spatial'][1]:.3f}) against the dense "
              f"step's {times['dense'][0]:.3f} (host {times['dense'][1]:.3f}),"
              f" tol {s['tol']} [{card}]")
    # The JAX package's gate (`__graft_entry__._dryrun_spatial_rollout`): a
    # CFL-reachable target 2 cells away, 25 cosine-decayed Adam steps.
    yy, xx = np.meshgrid(np.arange(H), np.arange(H), indexing="ij")

    def blob(cy, cx):
        return torch.tensor(np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                   / (0.01 * H * H)).astype(np.float32),
                            device="cuda")[None]

    domain = Domain2D.create(H, H, obstacle_mask=_plate(H), device="cuda")
    cfg = FluidConfig(dt=0.5, buoyancy=0.0, pressure_tol=1e-4,
                      pressure_maxiter=80, pressure_backend="pcg")
    state0 = FluidState(velocity=Staggered2D.zeros(1, H, H, device="cuda"),
                        density=blob(H * .3, H * .5))
    t0 = time.perf_counter()
    _, hist = optimize_forces_spatial(
        state0, blob(H * .3 + 2.0, H * .5 + 2.0), domain, cfg, mesh, n=3,
        iterations=25, learning_rate=0.4, force_reg=1e-7,
        lr_schedule="cosine")
    obs = hist["obs_loss"].cpu().numpy()
    improve = float(obs[0] / obs[-1])
    launches = _counts()
    print(f"optimize_forces_spatial 64^2, n=3, 25 iterations, 'pcg', cosine: "
          f"obs loss {obs[0]:.6e} -> {obs[-1]:.6e}, {improve:.2f}x in "
          f"{time.perf_counter() - t0:.2f} s; K1-K5 launches in the phase "
          f"{launches} [{card}]")
    if not (np.all(np.isfinite(obs)) and improve >= 2.0):
        raise AssertionError(f"spatial adjoint improved {improve:.2f}x < 2")
    if any(launches.values()):
        raise AssertionError(f"the spatial path launched a kernel: {launches}")
    return launches


# The "spatial3d" checks: the 3D split on a (1, 1) mesh at the 3D tasks'
# own sizes and domains against the dense `fluid3d_step`, with the JAX
# package's check's physics and tolerances
# (tests/_spatial3d_equality_check.py).
SPATIAL3D = dict(steps=3, dt=0.5, buoyancy=0.1, max_shift=1, tol=1e-7,
                 maxiter=800)
# label: (size, batch, plate, split mode, dense mode, buoyancy factor); with
# a factor the state carries the task's inflow and a warm-started pressure.
# 'jax' (plain CG) is held to the dense plain CG: on the task's plate both
# stall (the CG's safeguard freezes a sample whose residual grows 4x past
# its best) well above tol, where 'pcg' converges, so against 'pcg' the
# check would measure the solver and not the split.
SPATIAL3D_CASES = {
    "smoke3d spectral": (24, 4, False, "spectral", "spectral", None),
    "smoke3d auto": (24, 4, False, "auto", "auto", None),
    "smoke3d_indirect pcg, full factor": (32, 8, True, "pcg", "pcg", "full"),
    "smoke3d_indirect pcg, per-batch factor": (32, 8, True, "pcg", "pcg",
                                               "batch"),
    "smoke3d_indirect jax, full factor": (32, 8, True, "jax", "jax", "full"),
    "smoke3d_indirect jax, per-batch factor": (32, 8, True, "jax", "jax",
                                               "batch"),
}
# The gradients' relative L2 error against the dense step's. On the task's
# plate the float32 CG leaves the split and the dense gradients apart by
# up to ~1% in L2 and ~2% of the largest element in a few hundred
# elements (CPU, 32³ x 8), where the JAX check's elementwise atol on its
# mean loss no longer binds; this holds the whole gradient.
SPATIAL3D_GRAD_L2 = 3e-2
# scripts/spatial3d_memory.py's program: 128³, batch 1, n = 4, 'spectral'.
SPATIAL3D_MEMORY = dict(size=128, n=4, dt=0.5, buoyancy=0.05, tol=1e-4,
                        maxiter=100)


def _spatial3d_inputs(size: int, b: int, device) -> dict:
    """A density blob, the force, the target, the task's inflow and the
    two buoyancy factors, from SEED."""
    from pde_control_tpu_torch.experiments.smoke3d import (
        inflow3d_draws,
        inflow3d_from_draws,
    )

    rng = np.random.default_rng(SEED)
    zz, yy, xx = np.meshgrid(*(np.arange(size),) * 3, indexing="ij")

    def blob(r):
        c = r.uniform(size * 0.25, size * 0.75, (b, 3))
        return np.exp(-((zz[None] - c[:, 0, None, None, None]) ** 2
                        + (yy[None] - c[:, 1, None, None, None]) ** 2
                        + (xx[None] - c[:, 2, None, None, None]) ** 2)
                      / (0.06 * size * size)).astype(np.float32)

    def normal(*shape):
        return rng.normal(0, 0.05, (b,) + shape).astype(np.float32)

    n = size
    arrays = dict(density=blob(rng), fz=normal(n + 1, n, n),
                  fy=normal(n, n + 1, n), fx=normal(n, n, n + 1),
                  target=blob(np.random.default_rng(SEED + 7)),
                  bf_full=0.1 + 0.05 * blob(np.random.default_rng(SEED + 5)),
                  bf_batch=np.linspace(0.1, 0.2, b, dtype=np.float32)
                  .reshape(b, 1, 1, 1))
    x = {k: torch.tensor(v, device=device) for k, v in arrays.items()}
    gen = torch.Generator().manual_seed(SEED + 3)
    x["inflow"] = inflow3d_from_draws(inflow3d_draws(gen, b, n, n), n, n,
                                      n).to(device)
    return x


def _rollout3d(step, x: dict, factor, steps: int):
    """loss = mean((final density − target)²) of `steps` steps from rest
    with the force (and, with a buoyancy factor, the inflow and a
    warm-started pressure), and the gradients of the force and the
    factor."""
    from pde_control_tpu_torch import FluidState3D, Staggered3D

    b, d, h, w = x["density"].shape
    force = Staggered3D(*(x[k].clone().requires_grad_()
                          for k in ("fz", "fy", "fx")))
    bf = None if factor is None else x[f"bf_{factor}"].clone().requires_grad_()
    extra = {} if factor is None else dict(
        inflow=x["inflow"], pressure=torch.zeros_like(x["density"]))
    state = FluidState3D(velocity=Staggered3D.zeros(
        b, d, h, w, device=x["density"].device), density=x["density"],
        **extra)
    for _ in range(steps):
        state = step(state, force, bf)
    loss = torch.mean((state.density - x["target"]) ** 2)
    loss.backward()
    grads = [force.vz.grad, force.vy.grad, force.vx.grad]
    return loss.detach(), state, grads + ([] if bf is None else [bf.grad])


def _peak_mib(fn):
    """fn()'s result and the peak of device memory it allocated above
    what was allocated before it, in MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**20


def spatial3d_phase(card: str) -> dict:
    """The "spatial3d" phase on a (1, 1) mesh: `spatial_fluid3d_step` in
    each case of SPATIAL3D_CASES against the dense `fluid3d_step`, forward
    and gradients of the force and the factor; max|div| after projection,
    ms a forward step and the peak memory of rollout + backward beside
    the dense step's; `spatial_pressure_solve3d_diag` on the plate (the
    JAX package's trip gate and residual); scripts/spatial3d_memory.py's
    128³ program, split and dense."""
    _phase("spatial3d: the 3D split step on a (1, 1) mesh")
    from pde_control_tpu_torch import (
        Domain3D,
        Fluid3DConfig,
        FluidState3D,
        Staggered3D,
        fluid3d_step,
    )
    from pde_control_tpu_torch.experiments.smoke3d import obstacle_plate_3d
    from pde_control_tpu_torch.parallel.spatial3d import (
        make_mesh2d,
        spatial_fluid3d_step,
        spatial_pressure_solve3d_diag,
    )
    from pde_control_tpu_torch.physics.poisson import masked_laplace_spd

    mesh = make_mesh2d(1, 1)
    s = SPATIAL3D
    _zero_counts()
    print(f"limits: loss rtol 1e-5, final state rtol 1e-4 atol 1e-6, "
          f"gradients of the force and the factor rtol 1e-3 atol 2e-5; "
          f"{s['steps']} steps from rest, dt {s['dt']}, max_shift "
          f"{s['max_shift']}, tol {s['tol']}, maxiter {s['maxiter']}; each "
          f"gradient also within {SPATIAL3D_GRAD_L2} relative in L2")
    for label, (size, b, plate, mode, dense_mode, factor) in (
            SPATIAL3D_CASES.items()):
        domain = Domain3D.create(size, size, size, obstacle_mask=(
            obstacle_plate_3d(size, size, size) if plate else None),
            device="cuda")
        cfgs = [Fluid3DConfig(dt=s["dt"], buoyancy=s["buoyancy"],
                              max_shift=s["max_shift"], pressure_tol=s["tol"],
                              pressure_maxiter=s["maxiter"],
                              pressure_backend=m) for m in (mode, dense_mode)]
        x = _spatial3d_inputs(size, b, "cuda")

        def split(st, f, bf):
            return spatial_fluid3d_step(st, domain, cfgs[0], mesh, force=f,
                                        buoyancy_factor=bf)

        def dense(st, f, bf):
            return fluid3d_step(st, domain, cfgs[1], force=f,
                                buoyancy_factor=bf)

        sp, sp_mib = _peak_mib(lambda: _rollout3d(split, x, factor,
                                                  s["steps"]))
        de, de_mib = _peak_mib(lambda: _rollout3d(dense, x, factor,
                                                  s["steps"]))
        np.testing.assert_allclose(float(sp[0]), float(de[0]), rtol=1e-5,
                                   err_msg=label)
        v, vd = sp[1].velocity, de[1].velocity
        for name, got, want in (("density", sp[1].density, de[1].density),
                                ("vz", v.vz, vd.vz), ("vy", v.vy, vd.vy),
                                ("vx", v.vx, vd.vx)):
            np.testing.assert_allclose(got.detach().cpu().numpy(),
                                       want.detach().cpu().numpy(),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{label}: {name}")
        l2 = {}
        for name, got, want in zip(("fz", "fy", "fx", "factor"), sp[2],
                                   de[2]):
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-3, atol=2e-5,
                                       err_msg=f"{label}: gradient {name}")
            l2[name] = float((got - want).norm() / want.norm())
        if not max(l2.values()) <= SPATIAL3D_GRAD_L2:
            raise AssertionError(f"{label}: gradients' relative L2 {l2}")
        final = Staggered3D(v.vz.detach(), v.vy.detach(), v.vx.detach())
        div = float((final.divergence(domain.dx) * domain.fluid_mask)
                    .abs().max())
        state = FluidState3D(velocity=final, density=sp[1].density.detach(),
                             inflow=sp[1].inflow, pressure=(
                                 None if sp[1].pressure is None
                                 else sp[1].pressure.detach()))
        force = Staggered3D(x["fz"], x["fy"], x["fx"])
        bf = None if factor is None else x[f"bf_{factor}"]
        times = {}
        with torch.no_grad():
            for name, fn in (("split", split), ("dense", dense)):
                times[name] = (_time_ms(lambda: fn(state, force, bf), 5),)
                t0 = time.perf_counter()
                for _ in range(5):
                    fn(state, force, bf)
                torch.cuda.synchronize()
                times[name] += (1e3 * (time.perf_counter() - t0) / 5,)
        print(f"{label} ({size}^3 batch {b}, dense {dense_mode}): loss "
              f"{float(sp[0]):.9e} / {float(de[0]):.9e}, gradients' "
              f"relative L2 "
              + ", ".join(f"{k} {v:.2e}" for k, v in l2.items())
              + f", max|div| after projection {div:.3e}; a forward step "
              f"{times['split'][0]:.3f}"
              f" ms (host {times['split'][1]:.3f}) against the dense step's "
              f"{times['dense'][0]:.3f} (host {times['dense'][1]:.3f}); peak "
              f"of rollout + backward {sp_mib:.1f} MiB against "
              f"{de_mib:.1f} [{card}]")
    # The JAX package's trip gate (`main_iters`) on the task's plate.
    size = 32
    domain = Domain3D.create(size, size, size, obstacle_mask=(
        obstacle_plate_3d(size, size, size)), device="cuda")
    rng = np.random.default_rng(SEED)
    div = torch.tensor(rng.normal(0, 1, (1,) + (size,) * 3).astype(
        np.float32), device="cuda") * domain.fluid_mask
    dense64 = Domain3D.create(size, size, size, obstacle_mask=(
        obstacle_plate_3d(size, size, size)), dtype=torch.float64,
        device="cuda")
    fluid = domain.fluid_mask > 0
    rhs = torch.where(fluid, -div[0].double(), 0.0)
    rhs = torch.where(fluid, rhs - rhs[fluid].mean(), 0.0)
    trips, ms, rel = {}, {}, {}
    for mode in ("pcg", "jax"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, trips[mode] = spatial_pressure_solve3d_diag(
            div, domain, mesh, mode=mode, tol=1e-5, maxiter=2000)
        torch.cuda.synchronize()
        ms[mode] = 1e3 * (time.perf_counter() - t0)
        # The residual of the deflated system under the dense operator.
        ap = masked_laplace_spd(p.double(), dense64)[0]
        ap = torch.where(fluid, ap - ap[fluid].mean(), ap)
        rel[mode] = float((ap - rhs)[fluid].norm() / rhs[fluid].norm())
    print(f"spatial_pressure_solve3d_diag {size}^3 plate, tol 1e-5, maxiter "
          f"2000: " + ", ".join(f"{m} {trips[m]} trips in {ms[m]:.1f} ms, "
                                f"relative residual {rel[m]:.3e}"
                                for m in trips) + f" [{card}]")
    if not trips["pcg"] * 3 <= trips["jax"]:
        raise AssertionError(f"pcg trips {trips['pcg']} x 3 > jax "
                             f"{trips['jax']}")
    if not max(rel.values()) <= 10 * 1e-5:
        raise AssertionError(f"relative residuals {rel} > 10 x tol")
    spatial3d_memory(card, mesh)
    launches = _counts()
    print(f"K1-K5 launches in the phase {launches} [{card}]")
    if any(launches.values()):
        raise AssertionError(f"the spatial3d path launched a kernel: "
                             f"{launches}")
    return launches


def spatial3d_memory(card: str, mesh) -> None:
    """scripts/spatial3d_memory.py's program on the card: SPATIAL3D_MEMORY's
    n-step rollout of a uniform random density at 128³ from rest with a
    zero force, and the force's gradient, split on `mesh` and dense; the
    peak memory above the inputs and the ms of rollout + backward (a
    second run, after a first that warms up), the loss held at rtol 1e-5."""
    from pde_control_tpu_torch import (
        Domain3D,
        Fluid3DConfig,
        FluidState3D,
        Staggered3D,
        fluid3d_step,
    )
    from pde_control_tpu_torch.parallel.spatial3d import spatial_fluid3d_step

    m = SPATIAL3D_MEMORY
    size, n = m["size"], m["n"]
    domain = Domain3D.create(size, size, size, device="cuda")
    cfg = Fluid3DConfig(dt=m["dt"], buoyancy=m["buoyancy"],
                        pressure_tol=m["tol"], pressure_maxiter=m["maxiter"],
                        pressure_backend="spectral")
    rng = np.random.default_rng(0)
    density, target = (torch.tensor(rng.uniform(0, 1, (1,) + (size,) * 3)
                                    .astype(np.float32), device="cuda")
                       for _ in range(2))
    steps = {"split": lambda st, f: spatial_fluid3d_step(st, domain, cfg,
                                                         mesh, force=f),
             "dense": lambda st, f: fluid3d_step(st, domain, cfg, force=f)}
    out = {}
    for name, step in steps.items():
        def run():
            force = Staggered3D.zeros(1, size, size, size, device="cuda")
            force = Staggered3D(*(t.requires_grad_() for t in (
                force.vz, force.vy, force.vx)))
            state = FluidState3D(velocity=Staggered3D.zeros(
                1, size, size, size, device="cuda"), density=density)
            for _ in range(n):
                state = step(state, force)
            loss = torch.mean((state.density - target) ** 2)
            loss.backward()
            return loss.detach()

        loss, mib = _peak_mib(run)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out[name] = (float(loss), mib, 1e3 * (time.perf_counter() - t0))
    print(f"spatial3d_memory program {size}^3 batch 1 n={n} 'spectral' "
          f"(rollout + force gradient, no checkpointing): split loss "
          f"{out['split'][0]:.9e} peak {out['split'][1]:.1f} MiB "
          f"{out['split'][2]:.1f} ms; dense loss {out['dense'][0]:.9e} peak "
          f"{out['dense'][1]:.1f} MiB {out['dense'][2]:.1f} ms [{card}]")
    np.testing.assert_allclose(out["split"][0], out["dense"][0], rtol=1e-5)


def main() -> None:
    if sys.argv[1:2] == ["gloo-rank"]:  # a rank of the mesh phase's (b)
        _gloo_rank(int(sys.argv[2]), sys.argv[3])
        return
    card = device_phase()
    if sys.argv[1:] == ["burgers"]:  # the Burgers slice alone, no result
        adjoint_phase(card, burgers_phase(card))
        _phase(None)
        return
    if sys.argv[1:] == ["fused128"]:  # K2/K3 and the 128² app, no result
        build_phase()
        fused_kernel_phase(card)
        fused128_phase(card)
        _phase(None)
        return
    if sys.argv[1:] == ["fusedbig"]:  # K2/K3 beyond 128², no result line
        build_phase()
        print(json.dumps(fusedbig_phase(card)))
        _phase(None)
        return
    if sys.argv[1:] == ["k1big"]:  # K1 beyond 128², no result line
        build_phase()
        print(json.dumps(k1big_phase(card)))
        _phase(None)
        return
    if sys.argv[1:] == ["mesh"]:  # the mesh and spatial phases, no result
        build_phase()
        with _nccl_world():
            mesh_phase(card)
            spatial_phase(card)
            spatial3d_phase(card)
        gloo_phase(card)
        mesh_cli_phase(card)
        _phase(None)
        return
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
    golden = load_golden()
    unfused_launches = main_path_phase(card, batch, first, golden)
    fused_launches = fused_path_phase(card, batch, first, golden)
    conv_launches = conv_path_phase(card, batch, first, shapes, golden)
    fused128 = fused128_phase(card)
    k1big = k1big_phase(card)
    fusedbig = fusedbig_phase(card)
    training_phase(card, batch)
    configs, seen = {}, {3: {}, 5: {}}
    for number in (4, 3, 5):
        configs[number] = config_phase(card, number, seen.get(number))
    refined_128_phase(card, configs[5])
    ood = generalize_phase(card, configs)
    render_phase(card, configs)
    native_gather_phase(card, configs)
    gather_step_phase(card)
    conv_impls_phase(card)
    profile_bench_phase(card)
    cli_phase(card)
    entries = {name: entry_phase(card, name) for name in ENTRIES}
    adjoint_phase(card, burgers_phase(card))
    with _nccl_world():
        mesh = mesh_phase(card)
        spatial = spatial_phase(card)
        spatial3d = spatial3d_phase(card)
    gloo_phase(card)
    mesh_cli_phase(card)
    # The conv shapes of configs 3 and 5 that neither the main path nor
    # config 4's CFE check reaches, each held to plain under every plan
    # once.
    known = set(shapes) | set(CONFIG4_CONV_SHAPES)
    config_shapes = {}
    for m in (3, 5):
        config_shapes[f"config {m}"] = sorted(set(seen[m]) - known)
        known |= set(seen[m])
    # Last, so that its CUDA graphs' memory stays out of the paths' peaks.
    conv = conv_kernel_phase(card, shapes, config_shapes)
    _phase(None)

    def entry(name, source, replaces, launches, s, keys):
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": s["err"], "ms": s["ms"],
               "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
               "bound_by": s["bound_by"], "library_ms": s.get("library_ms"),
               **{k: s[k] for k in ("graph_ms", "plan") if k in s}}
        for m, c in sorted(configs.items()):
            out[f"config{m}_launches"] = sum(c["counted"][k] for k in keys)
            out[f"config{m}_graph_launches"] = sum(c["graph"][k] for k in keys)
        out["ood_launches"] = sum(ood[k] for k in keys)
        return out

    k1_summary = {key: float(np.mean([k1[s][key] for s in ("cold", "warm")]))
                  for key in ("ms", "plain_ms", "bound_ms")}
    k1_summary.update(err=max(k1[s]["err"] for s in ("cold", "warm")),
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
    # K1 at 128²x8 (smoke_128's solve) and every kernel's launches in the
    # 128² and 3D entries: data, eager (warm-up, captures, evals) and a
    # replay's times its steps.
    kernels[0].update({f"{k}_128x8": v for k, v in k1["big"].items()})
    # K2 and K3 at 128²x8 (the slice's settings, the large layout) and
    # their launches in the 128² app: an eager iteration's and a replay's
    # of each class.
    for kern, where, key in ((kernels[1], "fwd", "K2"), (kernels[2], "bwd", "K3")):
        kern.update({f"{k}_128x8": v for k, v in fused[where]["128x8"].items()})
        kern["fused128_launches"] = fused128["eager"][key]
        for seq in ("staggered", "chain"):
            kern[f"fused128_{seq}_graph_launches"] = fused128[seq][key]
    for kern, keys in zip(kernels, (("K1",), ("K2",), ("K3",),
                                    ("K4 fwd", "K4 dX"), ("K5",))):
        for name, counts in entries.items():
            kern[f"{name}_data_launches"] = sum(counts["data"][k] for k in keys)
            for label in (name, f"{name}_ft"):
                kern[f"{label}_launches"] = sum(counts[label]["counted"][k]
                                                for k in keys)
                kern[f"{label}_graph_launches"] = sum(
                    counts[label]["graph"][k] for k in keys)
    # The mesh phase's launches by the mesh=make_mesh(1) apps alone: eager
    # (the first iterations on the three paths, the graph app's warm-up and
    # capture) and a replay's times K_MESH; the spatial and spatial3d
    # phases', as counted.
    for kern, keys in zip(kernels, (("K1",), ("K2",), ("K3",),
                                    ("K4 fwd", "K4 dX"), ("K5",))):
        kern["mesh_launches"] = sum(mesh["counted"][k] for k in keys)
        kern["mesh_graph_launches"] = sum(mesh["graph"][k] for k in keys)
        kern["spatial_launches"] = sum(spatial[k] for k in keys)
        kern["spatial3d_launches"] = sum(spatial3d[k] for k in keys)
    # K1 beyond 128², in the banded layout: its own row (launches: the 256²
    # app's first iteration; times at 256²x8, and at 351²x8 beside them).
    kernels.append(k1big)
    # K2 and K3 beyond 128², in the banded layout: a row each (launches:
    # the 232² app's first iteration; times at 236²x8, and at 192²x8
    # beside them).
    kernels.extend(fusedbig)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
