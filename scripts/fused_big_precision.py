"""Where the plain fused step (K2/K3's plain versions) and the JAX package's
part beyond 128²: the port's step against `tests/goldens/fused_step_big.npz`
with its CG's preconditioner products as shipped (fp32), with their inputs
rounded to bf16 (the Pallas kernel's default dot precision on a TPU), and
in float64, on the CPU.

    python scripts/fused_big_precision.py [64x625] [236x236]

For each grid and case of the golden (a warm start with force and inflow;
zero velocity), prints vy4, vx4 and p against the golden in units of its
max|p|, rho1's max|d|, the worst cotangent against the golden in units of
its own max, and the forward and backward trip counts beside the golden's;
then, per output, the port's fp32 step against the JAX golden, against the
port's float64 step, and the golden against the float64 step. The golden
was written on the CPU, where XLA computes an fp32 dot in fp32 whatever
its precision says, so the bf16 rounding is what a TPU would have done,
not what the golden did. Takes ~2 min a grid.
"""

from __future__ import annotations

import inspect
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from pde_control_tpu_torch.ops import cuda_cg, cuda_fluid  # noqa: E402

import test_torch_fused_big as golden  # noqa: E402


def _bf16_input_pcg():
    """`cuda_cg.pcg_plain` with each preconditioner product's inputs
    rounded to bf16 (the products summed in fp32)."""
    ns = dict(vars(cuda_cg))
    ns["_mm"] = lambda a, b: torch.matmul(a.to(torch.bfloat16).float(),
                                          b.to(torch.bfloat16).float())
    exec(inspect.getsource(cuda_cg.pcg_plain).replace("torch.matmul(", "_mm("),
         ns)
    return ns["pcg_plain"]


def _step(state, ops, geom, cots, kw):
    out = cuda_fluid.fused_step_forward(*state, *geom, **ops, **kw)
    got = cuda_fluid.fused_step_backward(
        *state, *cots, *geom, has_force=True,
        has_inflow=ops["inflow"] is not None, **kw)
    return out, got


def main() -> None:
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    grids = [tuple(int(n) for n in a.split("x")) for a in sys.argv[1:]] or [(64, 625)]
    z = np.load(golden.GOLDEN)
    plain, tables = cuda_cg.pcg_plain, cuda_cg._tables
    variants = {"fp32 products": plain, "bf16-input products": _bf16_input_pcg()}
    for h, w in grids:
        for case in golden.CASES:
            state, ops, geom, cots, kw, outs, grads, trips = golden._case(
                z, h, w, case, "cpu")
            p_max = float(np.abs(outs[3]).max())
            fp32 = None
            for name, fn in variants.items():
                cuda_cg.pcg_plain = fn
                out, got = _step(state, ops, geom, cots, kw)
                cuda_cg.pcg_plain = plain
                fp32 = fp32 or (out, got)
                e_out = " ".join(
                    f"{golden.OUTS[i]} {np.abs(out[i].numpy() - outs[i]).max() / p_max:.2e}"
                    for i in (0, 1, 3))
                e_vjp = {n: float(np.abs(a.numpy() - g).max() / (np.abs(g).max() + 1e-9))
                         for n, a, g in zip(golden.GRADS, got, grads) if a is not None}
                worst = max(e_vjp, key=e_vjp.get)
                print(f"{h}x{w} {case}, {name}: out/max|p| {e_out}, rho1 "
                      f"{np.abs(out[2].numpy() - outs[2]).max():.2e}; worst "
                      f"cotangent d{worst} {e_vjp[worst]:.2e}; trips forward "
                      f"{out[4].tolist()} (golden {trips['fwd']}), backward "
                      f"{got[6].tolist()} (golden {trips['bwd']})", flush=True)
            # The same step in float64: the tables and every operand.
            cuda_cg._tables = lambda *a, **k: tuple(t.double() for t in tables(*a, **k))
            try:
                out64, got64 = _step(
                    *((tuple(None if t is None else t.double() for t in x)
                       if isinstance(x, tuple) else
                       {k: None if v is None else v.double() for k, v in x.items()}
                       if isinstance(x, dict) else [t.double() for t in x])
                      for x in (state, ops, geom, cots)), kw)
            finally:
                cuda_cg._tables = tables
            out, got = fp32
            print(f"{h}x{w} {case}, float64: trips forward {out64[4].tolist()}, "
                  f"backward {got64[6].tolist()}; max|d| in units of the "
                  "golden's max: port-JAX, port-f64, JAX-f64")
            rows = [("p", out[3], out64[3], outs[3], p_max)] + [
                (f"d{n}", a, a64, g, float(np.abs(g).max()) + 1e-9)
                for n, a, a64, g in zip(golden.GRADS, got, got64, grads)
                if a is not None]
            for name, a, a64, g, scale in rows:
                a, a64 = a.double().numpy(), a64.numpy()
                print(f"  {name:<8} {np.abs(a - g).max() / scale:.2e} "
                      f"{np.abs(a - a64).max() / scale:.2e} "
                      f"{np.abs(g - a64).max() / scale:.2e}", flush=True)


if __name__ == "__main__":
    main()
