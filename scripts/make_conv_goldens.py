"""Writes the 3×3 conv's goldens: the JAX package's Pallas conv and its VJP
in bf16 on a small batch, for the port's tests and smoke run to hold the
CUDA kernels (K4 forward and dX, K5 dW) and their plain versions to, on
machines where JAX is not installed.

    JAX_PLATFORMS=cpu python scripts/make_conv_goldens.py

Runs `pde_control_tpu.ops.pallas_conv.conv3x3(dtype=bfloat16,
interpret=True)` (the Pallas kernels in interpret mode) and `jax.vjp` of
it on the CPU, at 32×32, batch 2, with a bias, for four (Cin, Cout): the
CFE's first conv 5 → 32 (Cin not a multiple of 8), the CFE's 64 → 64, and
a U-net pair 16 → 16 and 32 → 16. The input, the kernel, the bias and the
output cotangent are drawn from a numpy seed and rounded to coarse steps
that float16 and bfloat16 both hold exactly (x and the cotangent to 1/16,
the kernel to 1/256, the bias to 1/64; stored as float16), which keeps the
file small. Writes `tests/goldens/conv3x3_32.npz` with, per case
`<cin>-<cout>`, the operands `x`, `k` (3, 3, Cin, Cout), `b`, `g` and the
results `y`, `dx`, `dw` (3, 3, Cin, Cout) and `db`, bfloat16 stored as
their uint16 bit patterns.
"""

from __future__ import annotations

import os
import sys

import numpy as np

H, B, SEED = 32, 2, 5
CASES = ((5, 32), (64, 64), (16, 16), (32, 16))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "goldens", "conv3x3_32.npz")


def main() -> None:
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    from pde_control_tpu.ops import pallas_conv

    rng = np.random.default_rng(SEED)

    def draw(shape, scale, step, limit):
        a = np.clip(np.round(scale * rng.normal(size=shape) / step) * step,
                    -limit, limit)
        return a.astype(np.float16)

    def bits(a) -> np.ndarray:
        return np.asarray(a, jnp.bfloat16).view(np.uint16)

    data = {}
    for cin, cout in CASES:
        case = f"{cin}-{cout}"
        ops = dict(x=draw((B, H, H, cin), 1.0, 1 / 16, 4.0),
                   k=draw((3, 3, cin, cout), 1 / np.sqrt(9 * cin), 1 / 256, 0.5),
                   b=draw((cout,), 0.1, 1 / 64, 0.5),
                   g=draw((B, H, H, cout), 1.0, 1 / 16, 4.0))
        x, k, b, g = (jnp.asarray(ops[n], jnp.bfloat16) for n in "xkbg")
        y, vjp = jax.vjp(lambda x, k, b: pallas_conv.conv3x3(
            x, k, b, dtype=jnp.bfloat16, interpret=True), x, k, b)
        dx, dw, db = vjp(g)
        for name, a in dict(ops, y=y, dx=dx, dw=dw, db=db).items():
            data[f"{case}/{name}"] = a if name in ops else bits(a)
        print(case, "max|y|", float(jnp.abs(y.astype(jnp.float32)).max()),
              flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **data)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
