"""The JAX package's draws of BASELINE configs 1-2 and 5, and the main
path's bf16 gradients against the JAX package's bf16 error, on the CPU.

* `tests/goldens/jax_draws_burgers.npz` and `jax_draws_config5.npz`
  (`scripts/make_jax_draws.py`): the files hold the reference's counts
  (1,024 + 128 Burgers trajectories in chunks of 64; 3,584 + 64 config-5
  trajectories in chunks of 8), and the first chunk of each split, fed
  through the port's `*_from_draws`, is what the JAX generators give at
  the setups' seeds, within 1e-6: `random_burgers_states` (the initial
  states, and the forces at amplitude 0.5), `random_smoke_blobs` and the
  two force fields of `generate_forced_smoke_dataset(init='blobs',
  force_amplitude=0.05)`. Then that chunk's 4-step rollout through
  `generate_forced_smoke_dataset` on config 5's domain and physics (a
  closed 64² box, the exact spectral solve) on both sides, within 1e-5 of
  the densities' max (the fp32 physics steps of two implementations).
* C16: the main path's 64² first iteration on the golden's weights
  (`chip_smoke.golden_first`, the run `tests/test_torch_fullsize.py`
  makes, shared when both files run in one process) with bf16 nets is
  no farther from the same path's fp32 gradient than the JAX package's
  bf16 gradient is from its own, per net and kind of leaf: within
  `chip_smoke.BF16_DIST_SCALE` × the JAX package's `bf16_dist` +
  `BF16_DIST_SLACK` (`tests/goldens/main_path_64_grads.npz`,
  `scripts/make_main_path_golden.py`). The fp32 gradient's sketch (its
  projections on 16 ±1 directions) against the JAX package's, as
  `chip_smoke.sketch_check` holds it.

Budget: ~15 s of one worker for the draws, and the two 64² iterations
when this file runs without `tests/test_torch_fullsize.py` in its process.
"""

import json
from pathlib import Path

import numpy as np
import torch

import jax

import chip_smoke
from pde_control_tpu.data import generate as jgen
from pde_control_tpu.grids import Domain2D as JDomain2D
from pde_control_tpu.physics.fluid import FluidConfig as JFluidConfig
from pde_control_tpu_torch.data import generate
from pde_control_tpu_torch.grids import Domain2D
from pde_control_tpu_torch.physics.fluid import FluidConfig

torch.set_num_threads(1)

GOLDENS = Path(__file__).resolve().parent / "goldens"


def _load(name: str):
    z = np.load(GOLDENS / f"jax_draws_{name}.npz")
    return z, json.loads(str(z["config"]))


def _first(z, split: str, keys: tuple, i: int = 0) -> tuple:
    return tuple(torch.from_numpy(np.array(z[f"{split}/{k}"][i])) for k in keys)


def _close(got: torch.Tensor, want, label: str) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6, err_msg=label)


def test_burgers_draws_are_the_jax_generators():
    """`generate_burgers_dataset`'s first chunk of each split: `key, k1,
    k2 = split(key, 3)`, k1 the initial states, k2 the forces (amplitude
    0.5, `experiments/burgers.py :: make_datasets`)."""
    z, meta = _load("burgers")
    assert (meta["size"], meta["chunk"]) == (32, 64)
    assert {s: (v["seed"], v["num"]) for s, v in meta["splits"].items()} == {
        "train": (0, 1024), "val": (999, 128)}
    for split, v in meta["splits"].items():
        chunks = v["num"] // 64
        assert z[f"{split}/amps"].shape == z[f"{split}/phases"].shape == (
            2 * chunks, 64, 3)
        _, k1, k2 = jax.random.split(jax.random.PRNGKey(v["seed"]), 3)
        for i, (k, amplitude) in enumerate(((k1, 1.0), (k2, 0.5))):
            got = generate.burgers_from_draws(
                *_first(z, split, ("amps", "phases"), i), 32,
                amplitude=amplitude)
            _close(got, jgen.random_burgers_states(k, 64, 32,
                                                   amplitude=amplitude),
                   f"{split} call {i}")


def test_config5_draws_are_the_jax_generators():
    """`generate_forced_smoke_dataset(init='blobs')`'s first chunk of each
    split: `key, k1, k2, k3 = split(key, 4)`, k1 the blobs, k2 and k3 the
    forces fy and fx (amplitude 0.05, `_natural_flow_setup`)."""
    z, meta = _load("config5")
    assert (meta["size"], meta["chunk"]) == (64, 8)
    assert {s: (v["seed"], v["num"]) for s, v in meta["splits"].items()} == {
        "train": (0, 3584), "val": (999, 64)}
    for split, v in meta["splits"].items():
        chunks = v["num"] // 8
        assert z[f"{split}/pos"].shape == (chunks, 8, 2)
        assert z[f"{split}/sig"].shape == (chunks, 8, 1, 1)
        assert z[f"{split}/amps"].shape == (2 * chunks, 8, 3, 3)
        _, k1, k2, k3 = jax.random.split(jax.random.PRNGKey(v["seed"]), 4)
        _close(generate.blobs_from_draws(*_first(z, split, ("pos", "sig")),
                                         64, 64),
               jgen.random_smoke_blobs(k1, 8, 64, 64), f"{split} blobs")
        for i, k in enumerate((k2, k3)):
            _close(generate.smooth_field_from_draws(
                *_first(z, split, ("amps", "phy", "phx"), i), 64, 64,
                amplitude=0.05),
                jgen.random_smooth_field_2d(k, 8, 64, 64, amplitude=0.05),
                f"{split} field {i}")


def test_config5_rollout_from_the_draws_matches_jax(monkeypatch):
    """The first training chunk rolled out 4 steps by the port's generator
    on the draws' pops against the JAX package's generator at seed 0."""
    z, _ = _load("config5")
    pops = {"blobs": 0, "field": 0}

    def pop(kind, keys):
        i = pops[kind]
        pops[kind] += 1
        return _first(z, "train", keys, i)

    monkeypatch.setattr(generate, "smooth_field_draws",
                        lambda gen, b, modes=3: pop("field", ("amps", "phy", "phx")))
    monkeypatch.setitem(generate.INITS, "blobs", (
        lambda gen, b, h, w, *a, **k: pop("blobs", ("pos", "sig")),
        generate.blobs_from_draws))
    kw = dict(dt=0.5, buoyancy=0.05, pressure_tol=1e-4, pressure_maxiter=200,
              warm_start_pressure=True)
    got = generate.generate_forced_smoke_dataset(
        Domain2D.create(64, 64, device="cpu"), FluidConfig(**kw), 8, 4,
        seed=0, force_amplitude=0.05, init="blobs")
    want = jgen.generate_forced_smoke_dataset(
        JDomain2D.create(64, 64), JFluidConfig(**kw), 8, 4, seed=0,
        force_amplitude=0.05, init="blobs")
    assert pops == {"blobs": 1, "field": 2}
    assert got.obs.shape == want.obs.shape == (8, 5, 64, 64, 1)
    err = np.abs(got.obs - want.obs).max() / np.abs(want.obs).max()
    assert err <= 1e-5, err


def test_bf16_gradients_within_the_jax_packages_bf16_error():
    """C16 on the CPU: the unfused path's plain iteration (K1's plain
    version), bf16 nets against fp32 nets on the golden's weights and
    batch, per net and kind of leaf; and the fp32 gradient's sketch."""
    golden, ref = chip_smoke.load_golden(), chip_smoke.load_golden_grads()
    assert (ref["params_sha256"], ref["batch_sha256"]) == (
        golden["params_sha256"], golden["batch_sha256"])
    bf16, fp32 = (chip_smoke.golden_first(golden, "cpu", "auto", "xla", case)
                  for case in ("bf16", "fp32"))
    assert bf16["grads"].keys() == fp32["grads"].keys()
    nets = {k.split("/")[0] for k in fp32["grads"]}
    assert set(ref["bf16_dist"]) == set(ref["fp32_sketch"]) == nets
    dist = chip_smoke.bf16_grads_check("plain", bf16["grads"], fp32["grads"],
                                       ref)
    # Every leaf is a kernel or a bias, and each net's bf16 error is real.
    assert all(set(kinds) == {"kernel", "bias"} and min(kinds.values()) > 0
               for kinds in dist.values())
    chip_smoke.sketch_check("plain", fp32["grads"], ref, 1e-5)
    # The sketch pairs leaves by their flax paths: on a tree with two
    # leaves of one shape swapped it parts from the JAX package's by far
    # more than the limit.
    a, b = "OP2/ConvBlock_1/Conv_0/kernel", "OP2/ConvBlock_1/Conv_1/kernel"
    swapped = dict(fp32["grads"], **{a: fp32["grads"][b], b: fp32["grads"][a]})
    err = np.max(np.abs(np.subtract(chip_smoke.grad_sketch(swapped)["OP2"],
                                    ref["fp32_sketch"]["OP2"])))
    assert err > 1e-2 * ref["fp32_norms"]["OP2"], err
