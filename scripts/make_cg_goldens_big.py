"""Writes the pressure solve's goldens beyond 128²: the JAX package's PCG
solve on grids where the port's kernel (K1) runs its banded layout, for the
port's tests and smoke run to hold K1 and its plain version to, on machines
where JAX is not installed.

    JAX_PLATFORMS=cpu python scripts/make_cg_goldens_big.py

Runs `pde_control_tpu.ops.pallas_cg.pallas_pressure_solve(interpret=True)`
(the Pallas kernel in interpret mode) on the CPU, on closed boxes with the
plate obstacle of `make_cg_goldens_128.py` (row h/2, columns h/4 to h/2),
dx 1, with the spectral preconditioner, at tol 1e-6:
  * `tests/goldens/pcg_256.npz`: 256², batch 2, cold ("cold") and from
    the guess `x0` ("warm"), maxiter 200;
  * `tests/goldens/pcg_edges.npz`: the Pallas gate's edges
    (`pallas_solve_fits`), batch 1: 351² from the guess ("351-warm", the
    largest square it admits warm) and 362² cold ("362-cold", the largest
    cold), maxiter 300.
Every sample stops by the tolerance, well within maxiter (the trip counts
are in the files). The inputs are drawn from a numpy seed and rounded to
float16 values (stored as such, exact in float32) to keep the files small.
Each file holds, per case, `<case>/div`, `<case>/x0` (warm cases), the
geometry (`<case>/acc_y`, `acc_x`, `fluid`; in `pcg_256.npz` one set,
unprefixed, and `div`, `x0` unprefixed), the pressure `<case>/p`, float32,
and `<case>/trips`, each sample's trip count from
`pde_control_tpu.physics.poisson.cg` on the same system (the Pallas kernel
returns none); `config` holds the solve's settings as JSON.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

SEED = 19
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
# file: (config, {case: (side, batch, warm)})
FILES = {
    "pcg_256.npz": (dict(dx=1.0, tol=1e-6, maxiter=200),
                    {"cold": (256, 2, False), "warm": (256, 2, True)}),
    "pcg_edges.npz": (dict(dx=1.0, tol=1e-6, maxiter=300),
                      {"351-warm": (351, 1, True), "362-cold": (362, 1, False)}),
}


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
    from pde_control_tpu.ops.pallas_cg import (
        pallas_pressure_solve,
        pallas_solve_fits,
    )
    from pde_control_tpu.physics.poisson import measure_pressure_iterations

    jax.config.update("jax_enable_x64", False)
    rng = np.random.default_rng(SEED)
    for name, (config, cases) in FILES.items():
        shared = name == "pcg_256.npz"  # one set of operands for both cases
        data = dict(config=json.dumps(config))
        operands = {}
        for case, (h, b, warm) in cases.items():
            assert pallas_solve_fits(b, h, h, warm), (case, "beyond the gate")
            if not (shared and operands):
                domain = Domain2D.create(h, h, obstacle_mask=jnp.asarray(plate(h)))
                operands = dict(
                    div=rng.normal(size=(b, h, h)).astype(np.float16),
                    x0=(0.5 * rng.normal(size=(b, h, h))).astype(np.float16),
                    acc_y=np.asarray(domain.acc_y, np.float32),
                    acc_x=np.asarray(domain.acc_x, np.float32),
                    fluid=np.asarray(domain.fluid_mask, np.float32))
                prefix = "" if shared else f"{case}/"
                for k, v in operands.items():
                    if k != "x0" or warm or shared:
                        data[prefix + k] = v
            geom = [jnp.asarray(operands[k]) for k in ("acc_y", "acc_x", "fluid")]
            div = jnp.asarray(operands["div"], jnp.float32)
            x0 = jnp.asarray(operands["x0"], jnp.float32) if warm else None
            t0 = time.perf_counter()
            p = pallas_pressure_solve(div, *geom, x0, closed=True, precond=True,
                                      interpret=True, **config)
            data[f"{case}/p"] = np.asarray(p, np.float32)
            trips = [int(measure_pressure_iterations(
                div[i:i + 1], domain, tol=config["tol"],
                maxiter=config["maxiter"],
                x0=None if x0 is None else x0[i:i + 1])[1]) for i in range(b)]
            assert max(trips) < config["maxiter"], (case, trips)
            data[f"{case}/trips"] = np.asarray(trips, np.int32)
            print(name, case, "max|p|", float(jnp.abs(p).max()), "trips", trips,
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        out = os.path.join(GOLDENS, name)
        np.savez_compressed(out, **data)
        print(f"wrote {out}: {os.path.getsize(out)} bytes", flush=True)


if __name__ == "__main__":
    main()
