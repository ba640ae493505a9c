"""Writes the pressure solve's goldens at 128²: the JAX package's PCG solve
on the grid of the `smoke_128` entries, for the port's tests and smoke run
to hold the CUDA kernel (K1) and its plain version to, on machines where
JAX is not installed.

    JAX_PLATFORMS=cpu python scripts/make_cg_goldens_128.py

Runs `pde_control_tpu.ops.pallas_cg.pallas_pressure_solve(interpret=True)`
(the Pallas kernel in interpret mode) on the CPU: a closed 128×128 box
with the plate obstacle (`obstacle[64, 32:64]`, the plate of
`make_cg_goldens.py` scaled up), batch 2, dx 1, maxiter 200 as
`smoke_128` runs it, with the spectral preconditioner, cold ("cold") and
from the guess `x0` ("warm"). The tolerance is 1e-6, tighter than
`smoke_128`'s 1e-4, so that a solve in another order of summation lands
close to these bits; every sample converges well within the 200 trips.
The inputs are drawn from a numpy seed and rounded to float16 values
(stored as such, exact in float32) to keep the file small. Writes
`tests/goldens/pcg_128.npz` with `np.savez_compressed`: `div`, `x0`, the
geometry (`acc_y`, `acc_x`, `fluid`), per case `<case>/p`, the pressure,
float32, and `<case>/trips`, each sample's trip count from
`pde_control_tpu.physics.poisson.cg` on the same system (the Pallas
kernel returns none); `config` holds the solve's settings as JSON.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

H, B, SEED = 128, 2, 13
CONFIG = dict(dx=1.0, tol=1e-6, maxiter=200)
CASES = {"cold": False, "warm": True}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "goldens", "pcg_128.npz")


def plate(h: int) -> np.ndarray:
    """The obstacle: one plate, row h/2, columns h/4 to h/2."""
    m = np.zeros((h, h), np.float32)
    m[h // 2, h // 4:h // 2] = 1.0
    return m


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    from pde_control_tpu.grids import Domain2D
    from pde_control_tpu.ops.pallas_cg import pallas_pressure_solve
    from pde_control_tpu.physics.poisson import measure_pressure_iterations

    jax.config.update("jax_enable_x64", False)
    rng = np.random.default_rng(SEED)
    data = dict(div=rng.normal(size=(B, H, H)).astype(np.float16),
                x0=(0.5 * rng.normal(size=(B, H, H))).astype(np.float16),
                config=json.dumps(CONFIG))
    domain = Domain2D.create(H, H, obstacle_mask=jnp.asarray(plate(H)))
    geom = [np.asarray(a, np.float32) for a in (domain.acc_y, domain.acc_x,
                                                domain.fluid_mask)]
    data.update(acc_y=geom[0], acc_x=geom[1], fluid=geom[2])
    div = jnp.asarray(data["div"], jnp.float32)
    for case, warm in CASES.items():
        x0 = jnp.asarray(data["x0"], jnp.float32) if warm else None
        t0 = time.perf_counter()
        p = pallas_pressure_solve(div, *map(jnp.asarray, geom), x0,
                                  closed=True, precond=True, interpret=True,
                                  **CONFIG)
        data[f"{case}/p"] = np.asarray(p, np.float32)
        trips = [int(measure_pressure_iterations(
            div[i:i + 1], domain, tol=CONFIG["tol"],
            maxiter=CONFIG["maxiter"],
            x0=None if x0 is None else x0[i:i + 1])[1]) for i in range(B)]
        data[f"{case}/trips"] = np.asarray(trips, np.int32)
        print(case, "max|p|", float(jnp.abs(p).max()), "trips", trips,
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **data)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
