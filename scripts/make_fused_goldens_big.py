"""Writes the fused fluid step's goldens beyond 128²: the JAX package's
fused step and its VJP at the Pallas fluid gate's square edge, 236², and
at its edge of 64 rows, 64×625, for the port's tests and smoke run to hold
the CUDA kernels (K2, K3; at both grids in the cluster core's banded
layout, K3's window phase in global memory) and their plain versions to,
on machines where JAX is not installed.

    JAX_PLATFORMS=cpu python scripts/make_fused_goldens_big.py

The recipe of `scripts/make_fused_goldens_128.py` at each grid, batch 1:
runs `pde_control_tpu.ops.pallas_fluid.fused_fluid_step(interpret=True)`
(the Pallas kernels in interpret mode) and `jax.vjp` of it on the CPU, on
a closed box with the plate obstacle (`obstacle[H // 2, W // 4:W // 2]`),
dt 1, max_shift 2, buoyancy 0.08, tol 1e-7 / maxiter 500, in the cases
"warm-force-inflow" (a warm start, a force and an inflow) and
"zero-velocity" (a force, velocity zero: the hat's and the clip's tie
points everywhere, a cold start). The inputs and the output cotangents
are drawn from a numpy seed and rounded to float16 values (stored as
such, exact in float32); the cases of a grid share the density, the force
and the output cotangents. Each solve's trip count comes from
`pde_control_tpu.physics.poisson.measure_pressure_iterations` on the same
system (the Pallas kernels return none); the script raises if one of them
reaches maxiter. Writes `tests/goldens/fused_step_big.npz` with
`np.savez_compressed`: per grid `<H>x<W>/<name>` the geometry (`acc_y`,
`acc_x`, `fluid`), the inputs (`vy`, `vx`, `rho`, `fy`, `fx`, `inflow`,
`x0`) and the output cotangents (`g_vy4`, `g_vx4`, `g_rho1`, `g_p`), and
per case `<H>x<W>/<case>/<name>` the outputs (`vy4`, `vx4`, `rho1`, `p`)
and the input cotangents (`d_vy`, `d_vx`, `d_rho`, `d_fy`, `d_fx`, and
`d_inflow` where the case has an inflow), float32; `config` holds the
step's settings, the grids and the trip counts (`trips`: per grid and
case `fwd` and `bwd`, one count) as JSON. ~3 min on one CPU core.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

GRIDS, B, SEED = ((236, 236), (64, 625)), 1, 20
CONFIG = dict(dt=1.0, dx=1.0, max_shift=2, buoyancy=0.08, closed=True,
              tol=1e-7, maxiter=500)
CASES = ("warm-force-inflow", "zero-velocity")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "goldens", "fused_step_big.npz")


def main() -> None:
    data, trips = {}, {}
    for h, w in GRIDS:
        grid, trips[f"{h}x{w}"] = golden(h, w)
        data.update({f"{h}x{w}/{k}": v for k, v in grid.items()})
    data["config"] = json.dumps(dict(CONFIG, grids=[list(g) for g in GRIDS],
                                     trips=trips))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **data)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes")


def golden(H: int, W: int) -> tuple[dict, dict]:
    """One grid's arrays (unprefixed) and trip counts."""
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    from pde_control_tpu.grids import Domain2D
    from pde_control_tpu.ops import pallas_fluid
    from pde_control_tpu.physics.poisson import measure_pressure_iterations

    jax.config.update("jax_enable_x64", False)
    plate = np.zeros((H, W), np.float32)
    plate[H // 2, W // 4:W // 2] = 1.0
    domain = Domain2D.create(H, W, obstacle_mask=jnp.asarray(plate))
    rng = np.random.default_rng(SEED + H + W)

    def draw(shape, scale=1.0, uniform=False):
        a = rng.uniform(0, 1, shape) if uniform else rng.normal(size=shape)
        return (scale * a).astype(np.float16)

    yf, xf, c = (B, H + 1, W), (B, H, W + 1), (B, H, W)
    data = dict(vy=draw(yf, 0.5), vx=draw(xf, 0.5), rho=draw(c, uniform=True),
                fy=draw(yf, 0.05), fx=draw(xf, 0.05),
                inflow=draw(c, 0.05, uniform=True), x0=draw(c, 0.5),
                g_vy4=draw(yf), g_vx4=draw(xf), g_rho1=draw(c), g_p=draw(c))
    data.update(acc_y=np.asarray(domain.acc_y), acc_x=np.asarray(domain.acc_x),
                fluid=np.asarray(domain.fluid_mask))
    f32 = {k: jnp.asarray(v, jnp.float32) for k, v in data.items()}
    geom = (f32["acc_y"], f32["acc_x"], f32["fluid"])
    cots = tuple(f32[k] for k in ("g_vy4", "g_vx4", "g_rho1", "g_p"))
    dx, tol, maxiter = CONFIG["dx"], CONFIG["tol"], CONFIG["maxiter"]
    # The transpose solve's system is the same in both cases: it runs cold
    # on -(g_p + div(acc * g_v4)), per sample.
    cot_p = cots[3] + jax.vmap(lambda gy, gx: pallas_fluid._divergence(
        gy * geom[0], gx * geom[1], dx))(cots[0], cots[1])

    def solve_trips(div, x0):
        return [int(measure_pressure_iterations(
            div[i:i + 1], domain, tol=tol, maxiter=maxiter,
            x0=None if x0 is None else x0[i:i + 1])[1]) for i in range(B)]

    trips = {}
    for case in CASES:
        t0 = time.perf_counter()
        zero_v = case == "zero-velocity"
        names = ["vy", "vx", "rho", "fy", "fx"] + ([] if zero_v else ["inflow"])
        args = [jnp.zeros_like(f32[k]) if zero_v and k in ("vy", "vx")
                else f32[k] for k in names]
        x0 = None if zero_v else f32["x0"]

        def step(*a, names=names, x0=x0):
            kw = dict(zip(names[3:], a[3:]))
            return pallas_fluid.fused_fluid_step(*a[:3], *geom, **kw, x0=x0,
                                                 interpret=True, **CONFIG)

        out, vjp = jax.vjp(step, *args)
        grads = vjp(cots)
        for name, o in zip(("vy4", "vx4", "rho1", "p"), out):
            data[f"{case}/{name}"] = np.asarray(o, np.float32)
        for name, g in zip(names, grads):
            data[f"{case}/d_{name}"] = np.asarray(g, np.float32)
        # The forward solve's divergence, per sample (a zero inflow adds
        # exact zeros).
        inflow = args[5] if len(args) > 5 else jnp.zeros_like(args[2])
        div = jax.vmap(lambda *a: pallas_fluid._phase_a(
            *a, *geom[:2], dt=CONFIG["dt"], dx=dx, k=CONFIG["max_shift"],
            buoy=CONFIG["buoyancy"])[3])(*args[:5], inflow)
        trips[case] = dict(fwd=solve_trips(div, x0),
                           bwd=solve_trips(-cot_p, None))
        print(f"{H}x{W}", case, "max|p|", float(jnp.abs(out[3]).max()),
              "max|d_vy|", float(jnp.abs(grads[0]).max()), "trips",
              trips[case], f"{time.perf_counter() - t0:.1f} s", flush=True)
        if max(max(t) for t in trips[case].values()) >= maxiter:
            raise RuntimeError(f"{H}x{W} {case}: a solve reached maxiter "
                               f"{maxiter}")
    return data, trips


if __name__ == "__main__":
    main()
