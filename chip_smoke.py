"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):
  1. device: needs CUDA; prints the card, its power limit and the TF32
     settings (both off);
  2. build: compiles the CUDA kernels from `pde_control_tpu_torch/csrc`,
     prints each kernel's registers and spills, and checks the kernels'
     shared-memory counts against the Python gates;
  3. the pressure solve (K1) against its plain torch version on the card:
     64² (bench plate, closed) and 32² (open, with an obstacle), batch 8,
     warm and cold, at tol 1e-4 / 100 iterations and tol 1e-6 / 500;
     residuals, solution error, trip counts, times, and the gradient
     through `solve_pressure` against the plain path;
  4. the fused step's forward (K2) and backward (K3) against their plain
     versions: 64² and 32², closed with the plate, batch 8, cold and warm,
     with force, with inflow, at zero velocity (the tie points), and with a
     NaN and an infinity planted in the velocity (the non-finite cells must
     be the plain version's), at tol 1e-6 / 500; then their times at
     64²×8, tol 1e-4 / 100;
  5. the main path, unfused: the 64² smoke-control training iteration
     (n=16, batch 8, full widths, bf16 nets) with the pressure solve on K1;
     the first iteration against the plain solve, 2 warm-up and 5 timed
     iterations, K1's launches;
  6. the main path, fused (`FluidConfig.fused='cuda'`): the same
     iteration with each step on K2 and K3; the first iteration against
     the unfused one on the same weights, 2 warm-up and 5 timed
     iterations, K2's and K3's launches.
The line before the last is the kernels' JSON summary; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import time

import numpy as np
import torch

H, N, BATCH = 64, 16, 8
SEED = 0
# One H100 SXM at its full power limit: fp32 outside the tensor cores, and
# HBM (NVIDIA's data sheet). Every kernel here is fp32 CUDA-core work.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


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
    from pde_control_tpu_torch.ops import _build, cuda_cg, cuda_fluid

    lib, info = _build.load()
    print(info.log.strip())
    print(f"build_seconds {info.seconds:.2f} ({info.path.name})")
    for block in info.log.split("Compiling entry function")[1:]:
        name = re.search(r"(pcg_kernel|fused_fwd_kernel|fused_bwd_kernel)", block)
        regs = re.search(r"Used (\d+) registers", block)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           block)
        if name and regs and spills:
            print(f"ptxas {name.group(1)}: {regs.group(1)} registers, "
                  f"{spills.group(1)} bytes spill stores, {spills.group(2)} "
                  f"bytes spill loads")
    for c_name, gate in (("pcg_shared_bytes", cuda_cg.shared_bytes),
                         ("fused_shared_bytes", cuda_fluid.shared_bytes)):
        fn = getattr(lib, c_name)
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_size_t
        if fn(H, H) != gate(H, H):
            raise AssertionError(f"{c_name}: kernel asks {fn(H, H)} bytes, the "
                                 f"gate counts {gate(H, H)}")
        print(f"{c_name}({H}, {H}) = {fn(H, H)} bytes, equal to the gate's count")


def _plate(n: int) -> np.ndarray:
    m = np.zeros((n, n), np.float32)
    m[n // 2, n // 4:n // 2] = 1.0
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


def kernel_phase(card: str) -> dict:
    _phase("K1 (pressure solve) against plain")
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
    print("limits: kernel residual <= max(2*tol, 2*plain residual); "
          "max|dp|/max|p| <= 100*tol; trip counts within 3 of plain; "
          "gradient max|dg|/max|g| <= 1e-3")
    for n, closed in ((H, True), (32, False)):
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

        def rel_res(p):
            r = torch.where(fluid, b - masked_laplace_spd(p, domain), 0.0)
            return float((r.norm(dim=(1, 2)) / b.norm(dim=(1, 2))).max())

        for tol, maxiter in ((1e-4, 100), (1e-6, 500)):
            for start, guess in (("cold", None), ("warm", x0)):
                args = dict(x0=guess, dx=domain.dx, closed=closed, tol=tol,
                            maxiter=maxiter)
                p_k, it_k = cuda_cg.pressure_solve(div, *geom, **args)
                p_p, it_p = cuda_cg.pcg_plain(div, *geom, **args)
                torch.cuda.synchronize()
                err = float((p_k - p_p).abs().max())
                rel = err / float(p_p.abs().max())
                res_k, res_p = rel_res(p_k), rel_res(p_p)
                dit = int((it_k - it_p).abs().max())
                print(f"{n}x{n} {'closed' if closed else 'open'} {start} "
                      f"tol={tol:g}: rel_residual kernel={res_k:.3e} "
                      f"plain={res_p:.3e} | max|dp|/max|p|={rel:.3e} | "
                      f"iters kernel={it_k.tolist()} plain={it_p.tolist()}")
                if not torch.isfinite(p_k).all():
                    raise AssertionError("kernel returned non-finite values")
                if res_k > max(2.0 * tol, 2.0 * res_p):
                    raise AssertionError(f"kernel residual {res_k:.3e} above "
                                         f"tol {tol:g}")
                if rel > 100 * tol:
                    raise AssertionError(f"kernel differs from plain by {rel:.3e}")
                if dit > 3:
                    raise AssertionError(f"trip counts differ by {dit} > 3")
                if n == H and tol == 1e-4:
                    kernel_ms = _time_ms(
                        lambda: cuda_cg.pressure_solve(div, *geom, **args), 50)
                    plain_ms = _time_ms(
                        lambda: cuda_cg.pcg_plain(div, *geom, **args), 5)
                    nbytes = (_nbytes(div, guess, p_k) + 4 * BATCH
                              + _geom_bytes(n, n))
                    bound_ms, bound_by = _bound(nbytes, _cg_flops(n, n, it_k))
                    print(f"  time per solve {n}x{n}x{BATCH} {start}: kernel "
                          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                          f"{bound_ms:.6f} ms ({bound_by}) [{card}]")
                    summary[start] = dict(err=err, ms=kernel_ms,
                                          plain_ms=plain_ms, bound_ms=bound_ms,
                                          bound_by=bound_by)

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


def _fused_operands(rng, n, case, domain, dev):
    """The step's operands and the four output cotangents, from `rng`."""
    from pde_control_tpu_torch.ops import cuda_fluid

    warm, inflow, zero_v, nonfinite = FUSED_CASES[case]

    def t(shape, scale=1.0, uniform=False):
        a = rng.uniform(0, 1, shape) if uniform else rng.normal(size=shape)
        return torch.tensor(scale * a, dtype=torch.float32, device=dev)

    v = 0.0 if zero_v else 0.5
    yf, xf, c = (BATCH, n + 1, n), (BATCH, n, n + 1), (BATCH, n, n)
    ops = dict(vy=t(yf, v), vx=t(xf, v), rho=t(c, uniform=True),
               fy=t(yf, 0.05), fx=t(xf, 0.05))
    if nonfinite:
        ops["vy"][0, n // 2, n // 3] = float("nan")
        ops["vx"][1, n // 3, n // 2] = float("inf")
    if inflow:
        ops["inflow"] = t(c, 0.05, uniform=True)
    if warm:  # a guess near this step's pressure, as the previous step's is
        p = cuda_fluid.fused_step_plain_forward(
            *(ops[k] for k in ("vy", "vx", "rho")), domain.acc_y, domain.acc_x,
            domain.fluid_mask, fy=ops["fy"], fx=ops["fx"], inflow=ops.get("inflow"),
            dx=domain.dx, tol=1e-6, maxiter=500, **FUSED_STEP)[3]
        ops["x0"] = (p + 0.05 * p.std() * t(c)).contiguous()
    return ops, [t(yf), t(xf), t(c), t(c)]


def fused_kernel_phase(card: str) -> dict:
    _phase("K2 / K3 (fused step forward / backward) against plain")
    from pde_control_tpu_torch.grids import Domain2D
    from pde_control_tpu_torch.ops import cuda_fluid

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    print("limits at tol 1e-6 / maxiter 500: each K2 output max|d|/max|ref| "
          "<= 1e-4, trip counts within 3; each K3 cotangent max|d|/max|ref| "
          "<= 1e-3, trip counts within 3; non-finite cells exactly the "
          "plain version's (none but in the non-finite case), errors over "
          "the finite cells")
    names_f = ("vy4", "vx4", "rho1", "p")
    names_b = ("g_vy", "g_vx", "g_rho", "g_fy", "g_fx", "g_inflow")
    err = {"fwd": 0.0, "bwd": 0.0}
    for n in (H, 32):
        domain = Domain2D.create(n, n, obstacle_mask=_plate(n), device=dev)
        geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
        for case in FUSED_CASES:
            ops, cots = _fused_operands(rng, n, case, domain, dev)
            kw = dict(FUSED_STEP, dx=domain.dx, tol=1e-6, maxiter=500)
            state = (ops.pop("vy"), ops.pop("vx"), ops.pop("rho"))
            out_k = cuda_fluid.fused_step_forward(*state, *geom, **ops, **kw)
            out_p = cuda_fluid.fused_step_plain_forward(*state, *geom, **ops, **kw)
            flags = dict(has_force=True, has_inflow="inflow" in ops)
            g_k = cuda_fluid.fused_step_backward(*state, *cots, *geom, **flags, **kw)
            g_p = cuda_fluid.fused_step_plain_backward(*state, *cots, *geom,
                                                       **flags, **kw)
            torch.cuda.synchronize()
            for where, got, want, names, limit in (
                    ("fwd", out_k, out_p, names_f, 1e-4),
                    ("bwd", g_k, g_p, names_b, 1e-3)):
                rels, n_bad = {}, 0
                for name, a, b in zip(names, got, want):
                    if (a is None) != (b is None):
                        raise AssertionError(f"{where} {name}: one side is None")
                    if a is None:
                        continue
                    fin = torch.isfinite(b)
                    if not torch.equal(torch.isfinite(a), fin):
                        raise AssertionError(f"{n}x{n} {case} {where} {name}: "
                                             "non-finite cells differ from plain")
                    n_bad += int((~fin).sum())
                    d = float((a[fin] - b[fin]).abs().max())
                    err[where] = max(err[where], d)
                    rels[name] = d / max(float(b[fin].abs().max()), 1e-30)
                if (n_bad > 0) != (case == "non-finite"):
                    raise AssertionError(f"{n}x{n} {case} {where}: {n_bad} "
                                         "non-finite cells")
                dit = int((got[-1] - want[-1]).abs().max())
                print(f"{n}x{n} {case} {where}: " + " ".join(
                    f"{k}={v:.2e}" for k, v in rels.items())
                    + f" | non-finite cells {n_bad}"
                    + f" | iters kernel={got[-1].tolist()} plain={want[-1].tolist()}")
                bad = {k: v for k, v in rels.items() if v > limit}
                if bad:
                    raise AssertionError(f"{n}x{n} {case} {where}: {bad} > {limit}")
                if dit > 3:
                    raise AssertionError(f"{n}x{n} {case} {where}: trip counts "
                                         f"differ by {dit} > 3")

    # Times at the main path's settings: 64², force, warm start, tol 1e-4.
    domain = Domain2D.create(H, H, obstacle_mask=_plate(H), device=dev)
    geom = (domain.acc_y, domain.acc_x, domain.fluid_mask)
    ops, cots = _fused_operands(rng, H, "warm", domain, dev)
    kw = dict(FUSED_STEP, dx=domain.dx, tol=1e-4, maxiter=100)
    state = (ops.pop("vy"), ops.pop("vx"), ops.pop("rho"))
    flags = dict(has_force=True, has_inflow=False)
    out = cuda_fluid.fused_step_forward(*state, *geom, **ops, **kw)
    grads = cuda_fluid.fused_step_backward(*state, *cots, *geom, **flags, **kw)
    timed = {
        "fwd": (lambda: cuda_fluid.fused_step_forward(*state, *geom, **ops, **kw),
                lambda: cuda_fluid.fused_step_plain_forward(*state, *geom, **ops,
                                                            **kw)),
        "bwd": (lambda: cuda_fluid.fused_step_backward(*state, *cots, *geom,
                                                       **flags, **kw),
                lambda: cuda_fluid.fused_step_plain_backward(*state, *cots, *geom,
                                                             **flags, **kw)),
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
        kernel_ms, plain_ms = _time_ms(kernel, 50), _time_ms(plain, 5)
        nbytes, flops = work[where]
        bound_ms, bound_by = _bound(nbytes + _geom_bytes(H, H), flops)
        iters = (out if where == "fwd" else grads)[-1]
        print(f"  time per {where} launch {H}x{H}x{BATCH} warm, tol 1e-4 "
              f"(trips {iters.tolist()}): kernel {kernel_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}; "
              f"{flops / 1e6:.1f} MFLOP, {nbytes / 1e6:.2f} MB) [{card}]")
        summary[where] = dict(err=err[where], ms=kernel_ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
    return summary


# ------------------------------------------------------------ phases 5 and 6


def make_app(backend: str = "auto", fused: str = "auto"):
    """The port's counterpart of `__graft_entry__._make_app(64, 16, 8)`
    (`fused='cuda'`: of `_make_app(64, 16, 8, fused='pallas')`)."""
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
    pde = IncompressibleFluidPDE(domain, cfg, control="buoyancy", unet_levels=3,
                                 cfe_features=(32, 64, 64, 32),
                                 op_base_features=16, dtype=torch.bfloat16)
    spans = [N >> i for i in range(N.bit_length() - 1)]  # 16, 8, 4, 2
    return ControlTraining(
        N, pde,
        trainable_networks=("CFE",) + tuple(f"OP{s}" for s in spans),
        sequence_class="staggered", obs_loss_frames=(N,), seed=SEED).prepare()


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


def _first_iteration(batch, backend: str, fused: str) -> tuple[float, dict]:
    app = make_app(backend, fused)
    metrics = app.compute_gradients(app.to_batch(batch))
    return float(metrics["loss"]), _grad_norms(app)


def _compare_first(label: str, got: tuple, ref: tuple) -> None:
    """Loss within 1e-3 relative, each net's gradient norm within 2e-2."""
    (loss_k, gn_k), (loss_p, gn_p) = got, ref
    print(f"first iteration loss: {label} {loss_k:.7e} reference {loss_p:.7e}")
    print(f"first iteration grad norms: {label} {gn_k} reference {gn_p}")
    if abs(loss_k - loss_p) > 1e-3 * abs(loss_p):
        raise AssertionError(f"{label}: first-iteration loss differs")
    for name in gn_p:
        if abs(gn_k[name] - gn_p[name]) > 2e-2 * gn_p[name] + 1e-12:
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
    from pde_control_tpu_torch.ops import cuda_cg, cuda_fluid

    cuda_cg.LAUNCHES = cuda_fluid.LAUNCHES_FWD = cuda_fluid.LAUNCHES_BWD = 0


def _counts() -> dict:
    from pde_control_tpu_torch.ops import cuda_cg, cuda_fluid

    return {"K1": cuda_cg.LAUNCHES, "K2": cuda_fluid.LAUNCHES_FWD,
            "K3": cuda_fluid.LAUNCHES_BWD}


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
    _expect("unfused", launches, {"K1": 2 * N - 1, "K2": 0, "K3": 0})
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
    _expect("fused", launches, {"K1": 0, "K2": N, "K3": N})
    return launches


def main() -> None:
    card = device_phase()
    build_phase()
    k1 = kernel_phase(card)
    fused = fused_kernel_phase(card)
    batch = make_batch()
    first = {"pcg": _first_iteration(batch, "pcg", "auto"),
             "auto": _first_iteration(batch, "auto", "auto"),
             "fused": _first_iteration(batch, "auto", "cuda")}
    unfused_launches = main_path_phase(card, batch, first)
    fused_launches = fused_path_phase(card, batch, first)

    def entry(name, source, replaces, launches, s):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": s["err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": s["bound_by"], "library_ms": None}

    k1_summary = {key: float(np.mean([s[key] for s in k1.values()]))
                  for key in ("ms", "plain_ms", "bound_ms")}
    k1_summary.update(err=max(s["err"] for s in k1.values()),
                      bound_by=k1["warm"]["bound_by"])
    kernels = [
        entry("pcg_pressure_solve", "pde_control_tpu_torch/csrc/pcg.cu",
              "pde_control_tpu/ops/pallas_cg.py:180", unfused_launches["K1"],
              k1_summary),
        entry("fused_step_forward", "pde_control_tpu_torch/csrc/fused_step.cu",
              "pde_control_tpu/ops/pallas_fluid.py:482", fused_launches["K2"],
              fused["fwd"]),
        entry("fused_step_backward", "pde_control_tpu_torch/csrc/fused_step.cu",
              "pde_control_tpu/ops/pallas_fluid.py:516", fused_launches["K3"],
              fused["bwd"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
