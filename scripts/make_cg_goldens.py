"""Writes the pressure solve's goldens: the JAX package's PCG solve on a
small grid, for the port's tests and smoke run to hold the CUDA kernel (K1)
and its plain version to, on machines where JAX is not installed.

    JAX_PLATFORMS=cpu python scripts/make_cg_goldens.py

Runs `pde_control_tpu.ops.pallas_cg.pallas_pressure_solve(interpret=True)`
(the Pallas kernel in interpret mode) on the CPU: a 32×32 box with the
plate obstacle (`obstacle[16, 8:16]`), batch 2, dx 1, tol 1e-7 / maxiter
500, with the spectral preconditioner, in three cases: "closed-cold",
"closed-warm" (from the guess `x0`) and "open-cold" (the same plate in an
open box). The inputs are drawn from a numpy seed and rounded to float16
values (stored as such, exact in float32) to keep the file small. Writes
`tests/goldens/pcg_32.npz`: the inputs `div` and `x0`, each box's
geometry (`closed/acc_y`, `closed/acc_x`, `closed/fluid`, and the same
under `open/`), and per case `<case>/p`, the pressure, float32; `config`
holds the solve's settings as JSON.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

H, B, SEED = 32, 2, 11
CONFIG = dict(dx=1.0, tol=1e-7, maxiter=500)
CASES = {"closed-cold": (True, False), "closed-warm": (True, True),
         "open-cold": (False, False)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "goldens", "pcg_32.npz")


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    from pde_control_tpu.grids import Domain2D
    from pde_control_tpu.ops.pallas_cg import pallas_pressure_solve

    jax.config.update("jax_enable_x64", False)
    plate = np.zeros((H, H), np.float32)
    plate[H // 2, H // 4:H // 2] = 1.0
    rng = np.random.default_rng(SEED)
    data = dict(div=rng.normal(size=(B, H, H)).astype(np.float16),
                x0=(0.5 * rng.normal(size=(B, H, H))).astype(np.float16),
                config=json.dumps(CONFIG))
    for box, closed in (("closed", True), ("open", False)):
        domain = Domain2D.create(H, H, obstacle_mask=jnp.asarray(plate),
                                 closed=closed)
        data[f"{box}/acc_y"] = np.asarray(domain.acc_y, np.float32)
        data[f"{box}/acc_x"] = np.asarray(domain.acc_x, np.float32)
        data[f"{box}/fluid"] = np.asarray(domain.fluid_mask, np.float32)
    div = jnp.asarray(data["div"], jnp.float32)
    for case, (closed, warm) in CASES.items():
        box = "closed" if closed else "open"
        geom = [jnp.asarray(data[f"{box}/{k}"]) for k in ("acc_y", "acc_x",
                                                          "fluid")]
        x0 = jnp.asarray(data["x0"], jnp.float32) if warm else None
        p = pallas_pressure_solve(div, *geom, x0, closed=closed, precond=True,
                                  interpret=True, **CONFIG)
        data[f"{case}/p"] = np.asarray(p, np.float32)
        print(case, "max|p|", float(jnp.abs(p).max()), flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **data)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
