"""Where the main path's bf16 gradients part from the JAX package's: the
64² first iteration on the golden's weights (`chip_smoke.golden_params`,
batch seed 0), on the CPU, by net and by kind of leaf.

    JAX_PLATFORMS=cpu python scripts/bf16_grads_probe.py

Computes every leaf's gradient four ways, the JAX package's app
(`__graft_entry__._make_app(64, 16, 8)`, 'pcg' on the CPU) and the port's
(`profile_bench.make_app(64, 16, 8, "cpu")`, K1's plain version), each
with bf16 and with fp32 nets, and prints for each net the relative L2
error against the JAX package's fp32 gradient of its kernels and of its
biases (all leaves of a kind together): JAX bf16, port bf16, port fp32.
Then the transpose of a bf16 bias add alone, `zeros(8, 64, 64, 16) +
bias.astype(bf16)`, as XLA's CPU backend runs it, against the fp32 sum of
the same bf16 cotangent. Takes ~4 min and a few GB (two JAX compiles of
the iteration).
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import jax
    import jax.numpy as jnp
    import torch

    import __graft_entry__ as graft
    import chip_smoke
    import make_main_path_golden
    from pde_control_tpu_torch.experiments import profile_bench
    from pde_control_tpu_torch.utils.convert import params_from_flax, params_to_flax

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    batch = graft._make_batch(64, 16, 8, 0)
    grads = {}
    for case in ("bf16", "fp32"):
        japp = (graft._make_app(64, 16, 8) if case == "bf16"
                else make_main_path_golden.fp32_app(graft))
        shapes = {k: np.shape(v) for k, v in
                  chip_smoke._flat(jax.device_get(japp.params)).items()}
        params = chip_smoke._nest(chip_smoke.golden_params(shapes))
        _, g = jax.jit(jax.value_and_grad(japp._loss_fn, has_aux=True))(
            params, batch)
        grads["jax", case] = chip_smoke._flat(jax.device_get(g))
        app = profile_bench.make_app(64, 16, 8, "cpu", backend="cuda")
        chip_smoke._nets_in(app, {"bf16": torch.bfloat16,
                                  "fp32": torch.float32}[case])
        app.load_params(params_from_flax(params))
        app.compute_gradients(app.to_batch(batch))
        grads["port", case] = chip_smoke._flat(params_to_flax(
            {n: {k: p.grad for k, p in net.named_parameters()}
             for n, net in app.nets.items()}))
    ref = grads["jax", "fp32"]
    others = [("jax", "bf16"), ("port", "bf16"), ("port", "fp32")]
    print("relative L2 error against the JAX package's fp32 gradient, by net "
          "and kind of leaf: " + ", ".join(f"{a} {b}" for a, b in others))
    for net in sorted({k.split("/")[0] for k in ref}):
        for kind in ("kernel", "bias"):
            keys = [k for k in ref if k.startswith(net + "/") and k.endswith(kind)]
            want = np.concatenate([np.ravel(ref[k]) for k in keys]).astype(np.float64)
            errs = []
            for o in others:
                got = np.concatenate([np.ravel(grads[o][k]) for k in keys])
                errs.append(np.linalg.norm(got - want) / np.linalg.norm(want))
            print(f"  {net:<5} {kind:<6} " + " ".join(f"{e:.3e}" for e in errs))
    rng = np.random.default_rng(0)
    dy = jnp.asarray(rng.normal(size=(8, 64, 64, 16)) * 1e-3 + 2e-4,
                     jnp.bfloat16)
    _, vjp = jax.vjp(lambda b: jnp.zeros(dy.shape, jnp.bfloat16)
                     + b.astype(jnp.bfloat16), jnp.zeros((16,), jnp.float32))
    got = jax.jit(vjp)(dy)[0]
    want = jnp.sum(dy.astype(jnp.float32), axis=(0, 1, 2))
    print("the bias add's transpose in bf16 (XLA, CPU) against the fp32 sum: "
          f"relative L2 {float(jnp.linalg.norm(got - want) / jnp.linalg.norm(want)):.3e}")


if __name__ == "__main__":
    main()
