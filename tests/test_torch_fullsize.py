"""The port against the JAX package at the sizes users run, on the CPU.

* The main path's batch: `profile_bench.make_batch(64, 16, 8, seed)` is
  `__graft_entry__._make_batch` bit for bit.
* The 64² first-iteration golden (`tests/goldens/main_path_64.npz`,
  `scripts/make_main_path_golden.py`): its weights, drawn by
  `chip_smoke.golden_params` on the parameter tree of
  `profile_bench.make_app(64, 16, 8, "cpu")`, have the golden's digest
  (so the port's tree is the JAX app's, leaf for leaf and shape for
  shape), load through `params_from_flax` and round-trip through
  `params_to_flax` bit for bit. Then the port's plain iteration (the plain solve for K1,
  cuDNN's place taken by torch's CPU conv) on them: with fp32 nets the
  loss within 1e-3 relative and each net's gradient norm within 2e-2 of
  the JAX package's, `chip_smoke._compare_first`'s limits (measured: 2e-7
  and 1e-6); with the main path's bf16 nets the loss within 1e-3
  (measured 4e-5). The bf16 gradients are held by their distance from the
  fp32 ones in `tests/test_torch_quality_draws.py`, which shares these
  runs through `chip_smoke.golden_first`'s cache. The trip means of the
  plain solves are within 10% of the JAX CG's.
* The JAX package's draws for configs 4 and 3
  (`tests/goldens/jax_draws_config{4,3}.npz`, `scripts/make_jax_draws.py`):
  the first chunk of each split is what the JAX package's key splits give
  at the setups' seeds (exact), and through the port's `*_from_draws` it is
  the JAX generators' fields within 1e-6, at the files' own 64² (the
  inflow positions and shape centres are drawn in grid units); the files
  hold the reference's counts (512 + 32 trajectories).
* C14, early stops on a closed box with a long side
  (`tests/goldens/pcg_closed.npz`, `scripts/make_cg_goldens_closed.py`):
  the JAX package's Pallas CG, cold at 64×600 with the plate, tol 1e-6,
  stops one sample's solve on the 4× rule at its best iterate of trip 7
  (relative residual 0.28), as the port's plain CG does (10 trips, the
  best iterate's three later). Held: each sample's trips within 3 or 10%
  of the golden's best-iterate trip, and its pressure within 5e-6 of its
  max|p| where the solve converged, 2e-5 where the rule stopped it
  (measured 2.1e-6 and 9.9e-6: that iterate is three orders of magnitude
  less converged than the others).

Budget: ~20 s of one worker, most of it the two 64² iterations and the
JAX package's first use.
"""

import json
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
import chip_smoke
from pde_control_tpu.data import generate as jgen
from pde_control_tpu_torch.data import generate
from pde_control_tpu_torch.experiments import profile_bench
from pde_control_tpu_torch.ops import cuda_cg
from pde_control_tpu_torch.utils.convert import params_from_flax, params_to_flax

torch.set_num_threads(1)

GOLDENS = Path(__file__).resolve().parent / "goldens"
H, N, B = 64, 16, 8


def test_make_batch_is_graft_entrys():
    for seed in (0, 3):
        got = profile_bench.make_batch(H, N, B, seed)
        want = graft._make_batch(H, N, B, seed)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_golden_weights_load_and_round_trip():
    """The weights drawn on the port's tree have the digest of those the
    golden script drew on the JAX app's: the digest covers every leaf's
    path and values, and the draws follow the shapes, so the two trees
    are equal leaf for leaf and shape for shape."""
    golden = chip_smoke.load_golden()
    app = profile_bench.make_app(H, N, B, "cpu")
    tree = chip_smoke._flat(params_to_flax(app.state_dicts()))
    params = chip_smoke.golden_params({k: v.shape for k, v in tree.items()})
    assert chip_smoke.digest(params) == golden["params_sha256"]
    assert chip_smoke.digest(profile_bench.make_batch(H, N, B, golden["seed"])
                             ) == golden["batch_sha256"]
    app.load_params(params_from_flax(chip_smoke._nest(params)))
    back = chip_smoke._flat(params_to_flax(app.state_dicts()))
    assert back.keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # The CFE's output layer is perturb_cfe's, so every net gets a gradient.
    assert np.abs(params["CFE/Conv_4/kernel"]).max() > 0


def test_first_iteration_matches_the_jax_golden():
    golden = chip_smoke.load_golden()
    got = chip_smoke.golden_first(golden, "cpu", "auto", "xla", "fp32")
    trips = got["trips"]
    ref = golden["cases"]["fp32"]
    chip_smoke._compare_first("plain, fp32 nets", (got["loss"], got["norms"]),
                              (ref["loss"], ref["grad_norms"]))
    for kind, key in (("warm", "trips_warm_mean"), ("cold", "trips_cold_mean")):
        mean = float(torch.cat(trips[kind]).float().mean())
        assert abs(mean - ref[key]) <= 0.1 * ref[key], (kind, mean, ref[key])
    assert (len(trips["warm"]), len(trips["cold"])) == (N, ref["cold_solves"])
    loss = chip_smoke.golden_first(golden, "cpu", "auto", "xla", "bf16")["loss"]
    ref = golden["cases"]["bf16"]
    assert abs(loss - ref["loss"]) <= 1e-3 * abs(ref["loss"])


def _smooth_field(key, b):
    k_amp, k_phy, k_phx = jax.random.split(key, 3)
    return (jax.random.normal(k_amp, (b, 3, 3)),
            jax.random.uniform(k_phy, (b, 3, 1), maxval=2 * jnp.pi),
            jax.random.uniform(k_phx, (b, 3, 1), maxval=2 * jnp.pi))


def _close(got: torch.Tensor, want, label: str) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6, err_msg=label)


def test_jax_draws_files_are_the_jax_packages():
    """Both configs, both splits: the first chunk against the key splits of
    `generate_inflow_smoke_dataset` (config 4: `key, k1, k2 = split(key,
    3)`) and `generate_forced_smoke_dataset` (config 3: `split(key, 4)`),
    and the fields built from it against the JAX generators'."""
    for config, amplitude in ((4, 1.0), (3, 0.1)):
        z = np.load(GOLDENS / f"jax_draws_config{config}.npz")
        meta = json.loads(str(z["config"]))
        assert (meta["size"], meta["chunk"]) == (H, 8)
        assert {s: v["num"] for s, v in meta["splits"].items()} == {
            "train": 512, "val": 32}
        calls = 1 if config == 4 else 2
        for split, v in meta["splits"].items():
            chunks = v["num"] // 8
            assert z[f"{split}/amps"].shape == (calls * chunks, 8, 3, 3)
            first = {k[len(split) + 1:]: torch.from_numpy(np.array(z[k][0]))
                     for k in z.files if k.startswith(split + "/")}
            fields = [tuple(torch.from_numpy(np.array(z[f"{split}/{k}"][i]))
                            for k in ("amps", "phy", "phx"))
                      for i in range(calls)]
            key = jax.random.PRNGKey(v["seed"])
            if config == 4:
                _, k1, k2 = jax.random.split(key, 3)
                keys = (k2,)
                _close(generate.inflow_from_draws(first["xs"], H, H),
                       jgen.random_inflow(k1, 8, H, H), f"{split} inflow")
            else:
                _, k1, k2, k3 = jax.random.split(key, 4)
                keys = (k2, k3)
                got = generate.shapes_from_draws(
                    first["pos"], first["r"], first["aspect"],
                    first["is_circle"], H, H)
                _close(got, jgen.random_shape_densities(k1, 8, H, H),
                       f"{split} shapes")
            for k, drawn in zip(keys, fields):
                for a, b in zip(drawn, _smooth_field(k, 8)):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                _close(generate.smooth_field_from_draws(*drawn, H, H,
                                                        amplitude=amplitude),
                       jgen.random_smooth_field_2d(k, 8, H, H,
                                                   amplitude=amplitude),
                       f"{split} field")


def test_closed_box_early_stop_matches_jax():
    z = np.load(GOLDENS / "pcg_closed.npz")
    kw = json.loads(str(z["config"]))
    t = {k: torch.tensor(z[k].astype(np.float32))
         for k in ("div", "acc_y", "acc_x", "fluid")}
    p, it = cuda_cg.pressure_solve(t["div"], t["acc_y"], t["acc_x"],
                                   t["fluid"], dx=kw["dx"], closed=True,
                                   tol=kw["tol"], maxiter=kw["maxiter"])
    want, trips, rel_res = z["p"], z["trips"], z["rel_res"]
    stopped = rel_res > 1e-2
    # The golden holds an early stop, and converged samples beside it.
    assert stopped.any() and not stopped.all()
    assert trips[stopped].max() < 20 <= trips[~stopped].min()
    it = it.numpy()
    assert np.all(np.abs(it - trips) <= np.maximum(3, 0.1 * trips)), (
        it.tolist(), trips.tolist())
    err = np.abs(p.numpy() - want).max(axis=(1, 2)) / np.abs(want).max(axis=(1, 2))
    limit = np.where(stopped, 2e-5, 5e-6)
    assert np.all(err <= limit), (err.tolist(), stopped.tolist())
