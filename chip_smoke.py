"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result):
  1. device: needs CUDA; prints the card, its power limit and the TF32
     settings (both off);
  2. build: compiles the CUDA kernels from `pde_control_tpu_torch/csrc`;
  3. kernel against its plain torch version on the card: the pressure solve
     at 64² (bench plate, closed) and 32² (open, with an obstacle), batch 8,
     warm and cold, at tol 1e-4 / 100 iterations and tol 1e-6 / 500;
     residuals, solution error, trip counts, times, and the gradient
     through `solve_pressure` against the plain path;
  4. the main path: the 64² smoke-control training iteration (n=16,
     batch 8, full widths, bf16 nets), 2 warm-up and 5 timed iterations,
     the kernel's launch count, and the first iteration against the same
     iteration with the plain pressure solve.
The line before the last is the kernels' JSON summary; the last line is
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import time

import numpy as np
import torch

H, N, BATCH = 64, 16, 8
SEED = 0


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
    from pde_control_tpu_torch.ops import _build

    lib, info = _build.load()
    print(info.log.strip())
    print(f"build_seconds {info.seconds:.2f} ({info.path.name})")
    from pde_control_tpu_torch.ops import cuda_cg

    fn = lib.pcg_shared_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_size_t
    if fn(H, H) != cuda_cg.shared_bytes(H, H):
        raise AssertionError(f"shared memory: kernel asks {fn(H, H)} bytes, "
                             f"the gate counts {cuda_cg.shared_bytes(H, H)}")
    print(f"pcg shared memory per block at {H}x{H}: {fn(H, H)} bytes")


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


def kernel_phase(card: str) -> dict:
    _phase("kernel against plain")
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
                    print(f"  time per solve {n}x{n}x{BATCH} {start}: kernel "
                          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms "
                          f"[{card}]")
                    summary[start] = dict(err=err, ms=kernel_ms,
                                          plain_ms=plain_ms,
                                          iters=float(it_k.float().mean()))

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


def make_app(backend: str = "auto"):
    """The port's counterpart of `__graft_entry__._make_app(64, 16, 8)`."""
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
                      pressure_backend=backend)
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


def main_path_phase(card: str) -> tuple[int, dict]:
    _phase("main path")
    from pde_control_tpu_torch.ops import cuda_cg

    batch = make_batch()
    # The first iteration, on the kernel and on the plain solve, same weights.
    first = {}
    for backend in ("pcg", "auto"):
        app = make_app(backend)
        metrics = app.compute_gradients(app.to_batch(batch))
        first[backend] = (float(metrics["loss"]), _grad_norms(app))
    (loss_k, gn_k), (loss_p, gn_p) = first["auto"], first["pcg"]
    print(f"first iteration loss: kernel {loss_k:.7e} plain {loss_p:.7e}")
    print(f"first iteration grad norms: kernel {gn_k} plain {gn_p}")
    if abs(loss_k - loss_p) > 1e-3 * abs(loss_p):
        raise AssertionError("first-iteration loss differs from the plain path")
    for name in gn_p:
        if abs(gn_k[name] - gn_p[name]) > 2e-2 * gn_p[name] + 1e-12:
            raise AssertionError(f"{name} gradient norm differs from the plain path")

    app = make_app("auto")
    # Trip counts of the kernel in one instrumented iteration.
    trips = {"warm": [], "cold": []}
    solve = cuda_cg.pressure_solve

    def recording(*args, **kw):
        p, it = solve(*args, **kw)
        trips["warm" if kw.get("x0") is not None else "cold"].append(it)
        return p, it

    cuda_cg.pressure_solve = recording
    try:
        app.progress(batch)
    finally:
        cuda_cg.pressure_solve = solve
    trip_means = {k: float(torch.cat(v).float().mean()) for k, v in trips.items()}
    print(f"kernel trip counts per solve in one iteration: warm mean "
          f"{trip_means['warm']:.2f} over {len(trips['warm'])} solves, cold mean "
          f"{trip_means['cold']:.2f} over {len(trips['cold'])} solves")

    app.progress(batch)  # second warm-up iteration
    before = {k: v.clone() for k, v in app.nets.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 5
    losses = []
    cuda_cg.LAUNCHES = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        losses.append(app.progress(batch)["loss"])
    end.record()
    torch.cuda.synchronize()
    launches = cuda_cg.LAUNCHES
    wall = time.perf_counter() - t0
    ms = start.elapsed_time(end) / iters
    losses = [float(x) for x in losses]
    print(f"losses {losses}")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite loss")
    changed = any(not torch.equal(v, before[k])
                  for k, v in app.nets.state_dict().items())
    if not changed:
        raise AssertionError("parameters did not change")
    # n warm forward solves; the backward runs a cold solve for every step
    # whose pressure reaches the loss: all but the last, whose velocity the
    # final-frame loss never reads.
    per_iter = N + (N - 1)
    print(f"pcg kernel launches: {launches} in {iters} iterations "
          f"(expected {per_iter} per iteration: {N} warm forward + {N - 1} cold "
          f"backward)")
    if launches != per_iter * iters:
        raise AssertionError(f"kernel launches {launches} != {per_iter * iters}")
    print(f"iteration {ms:.3f} ms (CUDA events; host clock {1e3 * wall / iters:.3f} "
          f"ms), steps/s {N * BATCH / (ms / 1e3):.1f} at {H}x{H} n={N} batch={BATCH}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB "
          f"[{card}]")
    return launches, trip_means


def main() -> None:
    card = device_phase()
    build_phase()
    summary = kernel_phase(card)
    launches, _ = main_path_phase(card)
    kernels = [{
        "name": "pcg_pressure_solve",
        "route": "cuda",
        "source": "pde_control_tpu_torch/csrc/pcg.cu",
        "replaces": "pde_control_tpu/ops/pallas_cg.py:180",
        "launches": launches,
        "max_abs_err": max(s["err"] for s in summary.values()),
        "ms": float(np.mean([s["ms"] for s in summary.values()])),
        "plain_ms": float(np.mean([s["plain_ms"] for s in summary.values()])),
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
