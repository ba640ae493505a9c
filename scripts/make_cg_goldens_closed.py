"""Writes the pressure solve's golden on a closed box with a long side: the
JAX package's cold PCG solve at 64×600, where some samples' solves stop
early on the 4× rule (`rs < 4.0 * rs_best`,
`pde_control_tpu/ops/pallas_cg.py:132`), for the port's tests to hold its
plain CG and K1 to.

    JAX_PLATFORMS=cpu python scripts/make_cg_goldens_closed.py

Runs `pde_control_tpu.ops.pallas_cg.pallas_pressure_solve(interpret=True)`
(the Pallas kernel in interpret mode) on the CPU, on a closed 64×600 box
with the plate of `make_cg_goldens_big.py` (row h/2, columns w/4 to w/2),
dx 1, with the spectral preconditioner, cold, at tol 1e-6 / maxiter 500,
batch 4. The right-hand sides are drawn from a numpy seed and rounded to
float16 values (stored as such, exact in float32).

`tests/goldens/pcg_closed.npz` holds `div`, the geometry (`acc_y`,
`acc_x`, `fluid`), the pressure `p` (float32), `trips`, each sample's trip
of its best iterate in the Pallas kernel (which returns no trip count):
the smallest maxiter at which the kernel, run on that sample alone,
returns its maxiter-500 pressure bit for bit (a bisection), `trips_xla`,
each sample's trip count from
`pde_control_tpu.physics.poisson.measure_pressure_iterations` (the JAX
package's XLA CG, with the same rules, whose products round otherwise),
`rel_res`, each sample's relative residual ‖b − A p‖ / ‖b‖ of the
kernel's pressure, and `config`, the settings as JSON. A sample the 4×
rule stopped has a relative residual far above tol and a best trip far
below the others'.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

SEED = 23
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "goldens", "pcg_closed.npz")
H, W, B = 64, 600, 4
CONFIG = dict(dx=1.0, tol=1e-6, maxiter=500)


def plate(h: int, w: int) -> np.ndarray:
    """The obstacle: one plate, row h/2, columns w/4 to w/2."""
    m = np.zeros((h, w), np.float32)
    m[h // 2, w // 4:w // 2] = 1.0
    return m


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    from pde_control_tpu.grids import Domain2D
    from pde_control_tpu.ops.pallas_cg import (
        pallas_pressure_solve,
        pallas_solve_fits,
    )
    from pde_control_tpu.physics.poisson import (
        masked_laplace_spd,
        measure_pressure_iterations,
    )

    assert pallas_solve_fits(B, H, W, False), "beyond the gate"
    rng = np.random.default_rng(SEED)
    domain = Domain2D.create(H, W, obstacle_mask=jnp.asarray(plate(H, W)))
    data = dict(config=json.dumps(dict(CONFIG, closed=True, warm=False)),
                div=rng.normal(size=(B, H, W)).astype(np.float16),
                acc_y=np.asarray(domain.acc_y, np.float32),
                acc_x=np.asarray(domain.acc_x, np.float32),
                fluid=np.asarray(domain.fluid_mask, np.float32))
    div = jnp.asarray(data["div"], jnp.float32)
    geom = [jnp.asarray(data[k]) for k in ("acc_y", "acc_x", "fluid")]
    t0 = time.perf_counter()
    p = pallas_pressure_solve(div, *geom, None, closed=True, precond=True,
                              interpret=True, **CONFIG)
    data["p"] = np.asarray(p, np.float32)

    def solve(i, maxiter):
        return np.asarray(pallas_pressure_solve(
            div[i:i + 1], *geom, None, closed=True, precond=True,
            interpret=True, dx=CONFIG["dx"], tol=CONFIG["tol"],
            maxiter=maxiter))

    def best_trip(i):
        full, lo, hi = solve(i, CONFIG["maxiter"]), 0, CONFIG["maxiter"]
        while hi - lo > 1:  # solve(i, hi) is full; solve(i, lo) is not
            mid = (lo + hi) // 2
            lo, hi = (lo, mid) if np.array_equal(solve(i, mid), full) else (mid, hi)
        return hi

    data["trips"] = np.asarray([best_trip(i) for i in range(B)], np.int32)
    data["trips_xla"] = np.asarray([int(measure_pressure_iterations(
        div[i:i + 1], domain, tol=CONFIG["tol"], maxiter=CONFIG["maxiter"])[1])
        for i in range(B)], np.int32)
    fluid = domain.fluid_mask
    n_fluid = jnp.maximum(jnp.sum(fluid), 1.0)

    def project(q):
        mean = jnp.sum(q * fluid, axis=(1, 2), keepdims=True) / n_fluid
        return jnp.where(fluid > 0, q - mean, q)

    b = project(jnp.where(fluid > 0, -div, 0.0))
    r = b - project(masked_laplace_spd(project(p), domain))
    data["rel_res"] = np.asarray(
        jnp.sqrt(jnp.sum(r * r, axis=(1, 2)) / jnp.sum(b * b, axis=(1, 2))),
        np.float32)
    print("max|p|", float(jnp.abs(p).max()), "best trips",
          data["trips"].tolist(), "XLA CG trips", data["trips_xla"].tolist(),
          "relative residuals", data["rel_res"].tolist(),
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    np.savez_compressed(OUT, **data)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes", flush=True)


if __name__ == "__main__":
    main()
