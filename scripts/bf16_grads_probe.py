"""Where the main path's bf16 gradients part from fp32, in both packages:
the 64² first iteration on the golden's weights (`chip_smoke.golden_params`,
batch seed 0), on the CPU, by net and by kind of leaf, and the kernels by
layer.

    JAX_PLATFORMS=cpu python scripts/bf16_grads_probe.py

Computes every leaf's gradient four ways, the JAX package's app
(`__graft_entry__._make_app(64, 16, 8)`, 'pcg' on the CPU) and the port's
(`profile_bench.make_app(64, 16, 8, "cpu")`, K1's plain version), each
with bf16 and with fp32 nets, and prints for each net the relative L2
distance of its kernels and of its biases (all leaves of a kind
together): JAX bf16 and port bf16 against their own fp32 gradient (the
`bf16_dist` that `chip_smoke.golden_check` holds, with its limit), then
JAX bf16, port bf16 and port fp32 against the JAX package's fp32; then
the same two `bf16_dist` figures for each conv's kernel.
Then the transpose of a bf16 bias add alone, `zeros(8, 64, 64, 16) +
bias.astype(bf16)`, as XLA's CPU backend runs it, against the fp32 sum of
the same bf16 cotangent. Takes ~5 min and a few GB (two JAX compiles of
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

    def dist(a, b, group):
        return chip_smoke.rel_dist(grads[a], grads[b], group)

    def by_kind(path):
        return path.split("/")[0], path.rsplit("/", 1)[1]

    own = {side: dist((side, "bf16"), (side, "fp32"), by_kind)
           for side in ("jax", "port")}
    vs_jax = {o: dist(o, ("jax", "fp32"), by_kind)
              for o in (("jax", "bf16"), ("port", "bf16"), ("port", "fp32"))}
    print("relative L2 distance by net and kind of leaf: bf16_dist (JAX bf16 "
          "vs JAX fp32, port bf16 vs port fp32, the limit 1.25 x JAX + 1e-3); "
          "against the JAX package's fp32: JAX bf16, port bf16, port fp32")
    for key in sorted(own["jax"]):
        limit = (chip_smoke.BF16_DIST_SCALE * own["jax"][key]
                 + chip_smoke.BF16_DIST_SLACK)
        print(f"  {key[0]:<5} {key[1]:<6} {own['jax'][key]:.3e} "
              f"{own['port'][key]:.3e} {limit:.3e} | "
              + " ".join(f"{vs_jax[o][key]:.3e}" for o in vs_jax))
    kernels = [k for k in grads["jax", "fp32"] if k.endswith("/kernel")]
    layer = {side: chip_smoke.rel_dist(
        {k: grads[side, "bf16"][k] for k in kernels},
        {k: grads[side, "fp32"][k] for k in kernels},
        lambda p: p.rsplit("/", 1)[0])
        for side in ("jax", "port")}
    print("bf16_dist of each conv's kernel: JAX, port, port / JAX")
    for name in sorted(layer["jax"]):
        j, q = layer["jax"][name], layer["port"][name]
        print(f"  {name:<28} {j:.4f} {q:.4f} {q / j:.3f}")
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
