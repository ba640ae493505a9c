"""Writes the golden of the main path's first training iteration at full
size: the JAX package's 64², n=16, batch-8 iteration, for the port's smoke
run to hold each of its training paths to on the card, where JAX is not
installed.

    JAX_PLATFORMS=cpu python scripts/make_main_path_golden.py

Runs on the CPU `__graft_entry__._make_app(64, 16, 8)` (the plate, the
buoyancy control, CFE 32-64-64-32, U-nets OP16-OP2 of base width 16 and 3
levels, the staggered class, a warm-started pressure solve at tol 1e-4 /
maxiter 100; off the TPU the solve takes the XLA path, 'pcg') with the
nets in bf16 (the main path's) and, on the same weights, in fp32. The
weights are `chip_smoke.py :: golden_params` of the JAX app's parameter
tree: each kernel N(0, 1/fan_in), flax's init scale, each bias 0, from a
numpy seed, and the CFE's output layer `Conv_4` replaced, as
`chip_smoke.py :: perturb_cfe` does, by 0.05·N(0, 1) from
`np.random.default_rng(3)` in flax's (3, 3, Cin, Cout) layout (at its
zero init no gradient reaches the OP nets). The nets hold 3.0 M
parameters, 12 MB in float32, so the file keeps their digest, not the
weights: the card draws them again and checks the digest. The batch is
`__graft_entry__._make_batch(64, 16, 8, SEED)`.

`tests/goldens/main_path_64.npz` holds `config`, JSON:
  * `seed`, the batch's seed; `params_sha256` and `batch_sha256`,
    `chip_smoke.digest` of the weights (keyed "net/module path/leaf", the
    flax tree `utils/convert.py :: params_from_flax` takes, nested by "/")
    and of the batch;
  * per case (`bf16`, `fp32`): `loss`; `grad_norms`, each net's gradient's
    L2 norm over all its leaves; `trips_warm_mean` over the iteration's 16
    warm forward solves and `trips_cold_mean` over its `cold_solves` cold
    backward solves with a nonzero right-hand side (the last step's has
    none and takes 0 trips; the port's autograd skips it), each sample's
    trip count from the JAX package's own CG (`physics/poisson.py :: cg`)
    on each solve's system, recorded through a wrapper of
    `physics/fluid.py`'s `solve_pressure` (forward: the divergence and the
    guess, each system once, although the rematerialised step body calls
    the recorder again in the backward sweep; backward: the pressure's
    cotangent);
and beside it, per case, `<case>/trips_warm` and `<case>/trips_cold`,
(16, 8) int32 arrays of those trip counts.

`tests/goldens/main_path_64_grads.npz` holds `config`, JSON, from the
same two runs' gradients, each leaf in flax's layout:
  * `bf16_dist`, per net and kind of leaf ('kernel', 'bias'),
    ||g_bf16 - g_fp32|| / ||g_fp32|| over all the net's leaves of that
    kind: how far the JAX package's bf16 gradient is from its own fp32
    one (`scripts/bf16_grads_probe.py` prints the same figures);
  * `fp32_sketch`, per net, the fp32 gradient projected on `directions`
    (16) directions of ±1 drawn from `np.random.default_rng(sketch_seed)`
    leaf by leaf in sorted order of the leaves' paths
    (`chip_smoke.grad_sketch`), and `fp32_norms`, each net's fp32
    gradient norm: the gradient held by direction, in 1 KB;
  * `fp32_sketch_spread`, per net, how far that sketch moves, over the
    net's norm, when every pressure solve of the fp32 iteration is
    tightened to tol `spread_tol` (1e-6, maxiter 500): the JAX package's
    own fp32 gradient is defined by direction no closer than that (the
    OP nets' gradients move by up to ~4e-4 of their norms);
  * `params_sha256` and `batch_sha256`, as in the golden.
`chip_smoke.py :: golden_check` holds each path's bf16 gradient to
`bf16_dist` and its fp32 gradient to the sketch.

A file whose arrays and config come out as those already on disk is left
as it is (`make_jax_draws.savez_if_changed`). Takes ~6 min and a few GB on
the CPU (three JAX compiles of the iteration).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "goldens", "main_path_64.npz")
OUT_GRADS = os.path.join(ROOT, "tests", "goldens", "main_path_64_grads.npz")
H, N, B = 64, 16, 8
SEED = 0
TOL, MAXITER = 1e-4, 100
TIGHT_TOL = 1e-6


def fp32_app(graft, **solve):
    """`graft._make_app(H, N, B)` with the nets in fp32; `solve` replaces
    fields of its `FluidConfig` (`pressure_tol`, `pressure_maxiter`)."""
    import dataclasses

    import jax.numpy as jnp

    from pde_control_tpu.control.pde_fluid import IncompressibleFluidPDE
    from pde_control_tpu.control.training import ControlTraining

    ref = graft._make_app(H, N, B).pde
    pde = IncompressibleFluidPDE(
        ref.domain, dataclasses.replace(ref.cfg, **solve), control="buoyancy",
        unet_levels=3,
        cfe_features=(32, 64, 64, 32), op_base_features=16,
        dtype=jnp.float32)
    return ControlTraining(
        N, pde, batch_size=B,
        trainable_networks=("CFE",) + tuple(f"OP{s}" for s in graft._spans(N)),
        sequence_class="staggered", obs_loss_frames=(N,)).prepare()


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from pde_control_tpu.physics import fluid as jfluid
    from pde_control_tpu.physics.poisson import cg, masked_laplace_spd

    # --- record each solve's system: forward (div, x0), backward (ct of p)
    recorded = {"warm": [], "cold": []}
    recording = {"on": False}
    solve = jfluid.solve_pressure

    @jax.custom_vjp
    def tap(p):
        return p

    def tap_fwd(p):
        return p, None

    def tap_bwd(_, ct):
        jax.debug.callback(
            lambda c: recording["on"] and recorded["cold"].append(np.array(c)),
            ct)
        return (ct,)

    tap.defvjp(tap_fwd, tap_bwd)

    def recording_solve(div, domain, tol=1e-5, maxiter=500, backend="auto",
                        x0=None):
        if x0 is None:
            raise AssertionError("the main path's forward solves are warm")
        jax.debug.callback(
            lambda d, g: recording["on"] and recorded["warm"].append(
                (np.array(d), np.array(g))), div, x0)
        return tap(solve(div, domain, tol=tol, maxiter=maxiter,
                         backend=backend, x0=x0))

    jfluid.solve_pressure = recording_solve

    import chip_smoke
    from make_jax_draws import savez_if_changed

    apps = {"bf16": graft._make_app(H, N, B), "fp32": fp32_app(graft)}
    domain = apps["bf16"].pde.domain
    shapes = {k: np.shape(v) for k, v in chip_smoke._flat(
        jax.device_get(apps["bf16"].params)).items()}
    flat_params = chip_smoke.golden_params(shapes)
    params = chip_smoke._nest(flat_params)
    batch = graft._make_batch(H, N, B, SEED)

    # --- the solves' trip counts, per sample, by the JAX package's CG on
    # the 'pcg' path's system (solve_pressure's closures, rebuilt).
    from pde_control_tpu.ops.spectral import spectral_neumann_solve

    fluid = domain.fluid_mask
    n_fluid = jnp.maximum(jnp.sum(fluid), 1.0)

    def project(p):
        mean = jnp.sum(p * fluid, axis=(1, 2), keepdims=True) / n_fluid
        return jnp.where(fluid > 0, p - mean, p)

    def matvec(p):
        return project(masked_laplace_spd(project(p), domain))

    def precond(r):
        return project(spectral_neumann_solve(project(r), dx=domain.dx))

    @jax.jit
    def trips_warm(div, x0):
        b = project(jnp.where(fluid > 0, -div, 0.0))
        return cg(matvec, b, tol=TOL, maxiter=MAXITER, x0=project(x0),
                  precond=precond, return_iters=True)[1]

    @jax.jit
    def trips_cold(ct):
        return cg(matvec, project(ct), tol=TOL, maxiter=MAXITER,
                  precond=precond, return_iters=True)[1]

    data, flat_grads = {}, {}
    config = dict(h=H, n=N, batch=B, tol=TOL, maxiter=MAXITER,
                  backend="pcg (XLA)", seed=SEED,
                  params_sha256=chip_smoke.digest(flat_params),
                  batch_sha256=chip_smoke.digest(batch), cases={})
    for case, app in apps.items():
        t0 = time.perf_counter()
        grad_fn = jax.jit(jax.value_and_grad(app._loss_fn, has_aux=True))
        recorded["warm"].clear()
        recorded["cold"].clear()
        recording["on"] = True
        (loss, _), grads = grad_fn(params, batch)
        jax.block_until_ready(grads)
        recording["on"] = False
        grads = jax.device_get(grads)
        flat_grads[case] = chip_smoke._flat(grads)
        # The rematerialised step body runs its forward solve's callback
        # again in the backward sweep: keep each system once, in order.
        warm, seen = [], set()
        for d, g in recorded["warm"]:
            key = (d.tobytes(), g.tobytes())
            if key not in seen:
                seen.add(key)
                warm.append((d, g))
        cold = list(recorded["cold"])
        if len(warm) != N or len(cold) != N:
            raise AssertionError(f"{case}: recorded {len(warm)} warm and "
                                 f"{len(cold)} cold solves, want {N} each")
        tw = np.array([[int(trips_warm(d[i:i + 1], g[i:i + 1]))
                        for i in range(B)] for d, g in warm], np.int32)
        tc = np.array([[int(trips_cold(c[i:i + 1])) for i in range(B)]
                       for c in cold], np.int32)
        norms = {}
        for net, g in grads.items():
            leaves = jax.tree_util.tree_leaves(g)
            norms[net] = float(np.sqrt(sum(float(np.sum(np.square(
                np.asarray(x, np.float64)))) for x in leaves)))
        data[f"{case}/trips_warm"] = tw
        data[f"{case}/trips_cold"] = tc
        live = tc[tc.sum(axis=1) > 0]
        config["cases"][case] = dict(
            loss=float(loss), grad_norms=norms,
            trips_warm_mean=float(tw.mean()),
            trips_cold_mean=float(live.mean()), cold_solves=len(live))
        print(case, json.dumps(config["cases"][case]),
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    data["config"] = json.dumps(config)
    savez_if_changed(OUT, data)
    dist = chip_smoke.bf16_dist(flat_grads["bf16"], flat_grads["fp32"])
    print("bf16_dist (JAX bf16 against JAX fp32):", json.dumps(dist), flush=True)
    # The sketch's spread: the fp32 iteration again with every solve
    # tightened to tol 1e-6 (maxiter 500).
    tight_app = fp32_app(graft, pressure_tol=TIGHT_TOL, pressure_maxiter=500)
    _, grads = jax.jit(jax.value_and_grad(tight_app._loss_fn, has_aux=True))(
        params, batch)
    norms = config["cases"]["fp32"]["grad_norms"]
    loose = chip_smoke.grad_sketch(flat_grads["fp32"])
    tight = chip_smoke.grad_sketch(chip_smoke._flat(jax.device_get(grads)))
    spread = {net: float(np.max(np.abs(np.subtract(loose[net], tight[net])))
                         / norms[net]) for net in sorted(loose)}
    print("fp32 sketch spread (tol 1e-4 against 1e-6):", json.dumps(spread),
          flush=True)
    savez_if_changed(OUT_GRADS, {"config": json.dumps(dict(
        sketch_seed=chip_smoke.SKETCH_SEED,
        directions=chip_smoke.SKETCH_DIRECTIONS,
        params_sha256=config["params_sha256"],
        batch_sha256=config["batch_sha256"], bf16_dist=dist,
        fp32_sketch=loose,
        fp32_norms=norms, fp32_sketch_spread=spread,
        spread_tol=TIGHT_TOL, spread_maxiter=500))})


if __name__ == "__main__":
    main()
