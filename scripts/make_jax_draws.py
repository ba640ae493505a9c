"""Writes the JAX package's random draws for the datasets of BASELINE configs
1-2, 3, 4 and 5 and of the out-of-distribution evals, in the port's
`*_draws` layouts, so that the port can generate the JAX package's own
training and validation sets on a machine without JAX.

    JAX_PLATFORMS=cpu python scripts/make_jax_draws.py

A file whose arrays and config are already those on disk is left as it
is (`savez_if_changed`: a zip written anew differs in its timestamps
alone). The datasets themselves (config 4:
512 + 32 trajectories of 17 frames at 64²; config 5: 3,584 + 64 of 129
frames) are hundreds of MB to GB; their draws are KB. This script repeats
the JAX package's key splits, chunk by chunk, at the seeds of the setups
(train 0, val 999; `pde_control_tpu/experiments/fluid2d.py ::
_smoke_indirect_setup, _shape_transition_setup, _natural_flow_setup`,
`pde_control_tpu/experiments/burgers.py :: make_datasets`), in the
generators' chunks (`generate_*_dataset(batch=...)`'s defaults: 64 for
Burgers, 8 for the smoke sets):

* `tests/goldens/jax_draws_config4.npz`, from
  `pde_control_tpu/data/generate.py :: generate_inflow_smoke_dataset`:
  `key, k1, k2 = split(key, 3)` a chunk; k1 → `random_inflow`'s source
  positions, `<split>/xs` (chunks, 8, 1, 1) in grid units; k2 →
  `random_smooth_field_2d`'s unit-normal amplitudes and phases,
  `<split>/amps` (calls, 8, 3, 3), `<split>/phy` and `<split>/phx` (calls,
  8, 3, 1), one call a chunk;
* `tests/goldens/jax_draws_config3.npz`, from
  `generate_forced_smoke_dataset(init='shapes')`: `key, k1, k2, k3 =
  split(key, 4)` a chunk; k1 → `random_shape_densities`' centres
  `<split>/pos` (chunks, 8, 2) as (y, x), half-sizes `<split>/r`, box
  aspects `<split>/aspect` (chunks, 8, 1, 1) and `<split>/is_circle`
  (bool); k2 and k3 → the two force fields' draws, two calls a chunk (fy,
  then fx) in `<split>/amps`, `phy`, `phx`;
* `tests/goldens/jax_draws_config5.npz`, from
  `generate_forced_smoke_dataset(init='blobs', force_amplitude=0.05)`
  (3,584 + 64 trajectories, 448 + 8 chunks): k1 → `random_smoke_blobs`'
  centres `<split>/pos` (chunks, 8, 2) and widths `<split>/sig` (chunks,
  8, 1, 1); k2 and k3 as config 3's;
* `tests/goldens/jax_draws_burgers.npz` (configs 1 and 2 draw the same
  sets), from `generate_burgers_dataset` at N = 32 (1,024 + 128
  trajectories, 16 + 2 chunks of 64): `key, k1, k2 = split(key, 3)` a
  chunk; k1 → `random_burgers_states`' unit-normal amplitudes
  `<split>/amps` and phases `<split>/phases` (calls, 64, 3) of the initial
  states, k2 → those of the forces, two calls a chunk (state, then force).

The out-of-distribution evals' sets (`pde_control_tpu/experiments/
generalize.py`), 32 trajectories a case at 64², n = 16, in chunks of 8,
each split named by its case:

* `tests/goldens/jax_draws_ood_shapes.npz` (`generalize_shapes`): the
  splits `shapes` (seed 999), `crosses` (1999) and `rings` (2999) of
  `generate_forced_smoke_dataset(init=<case>)`, k1 → the family's draws
  (`shapes`: as config 3's; `crosses`: centres `pos`, arm lengths `arm`
  and thickness fractions `thick_frac`; `rings`: `pos`, outer radii
  `r_out` and inner fractions `in_frac`, (chunks, 8, 1, 1)), k2 and k3 the
  two force fields. `shapes` is config 3's validation set: its arrays are
  held equal to `jax_draws_config3.npz`'s `val` split as they are written;
* `tests/goldens/jax_draws_ood_smoke.npz` (`generalize_smoke`): the
  splits `in_dist` (999), `obstacles_ood` (1999), `inflow_shifted` (2999,
  `inflow_kwargs` y0 = 10 and x_range (0.05, 0.30): its `xs` lie in that
  band), `horizon_24` (4023) and `horizon_32` (4031) of
  `generate_inflow_smoke_dataset`, in config 4's layout. The horizon
  changes the rollout, not the draws.

`config` holds, for each split, its case's seed, count, the port's draw
functions it pops (`kinds`) and its `init`, `inflow_kwargs` or `horizon`.

The layouts are those of `pde_control_tpu_torch/data/generate.py ::
inflow_draws, shape_draws, blob_draws, cross_draws, ring_draws,
burgers_draws, smooth_field_draws`; fed through the matching
`*_from_draws` they give the JAX generators' fields (within 1e-6,
`tests/test_torch_fullsize.py`, `tests/test_torch_quality_draws.py`,
`tests/test_torch_quality_ood.py`). `config` holds the grid, the chunk
size, the seeds and the counts as JSON. `scripts/quality_torch.py`
replaces the port's draw functions by pops from these files.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
# file name -> (grid, chunk, {split: (seed, trajectories)}): the reference
# runs' counts. Configs 4 and 3: 512 training trajectories
# (scripts/run_quality11.sh) and the setups' 32 validation ones; config 5:
# 3,584 + 64 (scripts/run_queue_r3c.sh); Burgers: `run_chain_supervised`'s
# and `run_hierarchical`'s defaults, 1,024 + 128.
FILES = {"config4": (64, 8, {"train": (0, 512), "val": (999, 32)}),
         "config3": (64, 8, {"train": (0, 512), "val": (999, 32)}),
         "config5": (64, 8, {"train": (0, 3584), "val": (999, 64)}),
         "burgers": (32, 64, {"train": (0, 1024), "val": (999, 128)})}
# The out-of-distribution files: file name -> (grid, chunk, trajectories a
# case, {case: its generator's seed and arguments}), the seeds and
# arguments of `generalize_shapes` and `generalize_smoke`
# (`pde_control_tpu/experiments/generalize.py`), 32 validation
# trajectories a case.
OOD_FILES = {
    "ood_shapes": (64, 8, 32, {
        "shapes": dict(seed=999, init="shapes"),
        "crosses": dict(seed=1999, init="crosses"),
        "rings": dict(seed=2999, init="rings")}),
    "ood_smoke": (64, 8, 32, {
        "in_dist": dict(seed=999),
        "obstacles_ood": dict(seed=1999),
        "inflow_shifted": dict(seed=2999, inflow_kwargs=dict(
            y0=10.0, x_range=(0.05, 0.30))),
        "horizon_24": dict(seed=3999 + 24, horizon=24),
        "horizon_32": dict(seed=3999 + 32, horizon=32)}),
}
# The generator of each file of FILES: Burgers, the inflow sets, or the
# forced sets of one initial family.
KINDS = {"burgers": ("burgers", None), "config4": ("inflow", None),
         "config3": ("forced", "shapes"), "config5": ("forced", "blobs")}


def smooth_field_draws(key, batch: int, modes: int = 3):
    """`random_smooth_field_2d`'s draws from `key`: amps (B, M, M), phy and
    phx (B, M, 1)."""
    import jax
    import jax.numpy as jnp

    k_amp, k_phy, k_phx = jax.random.split(key, 3)
    return (jax.random.normal(k_amp, (batch, modes, modes)),
            jax.random.uniform(k_phy, (batch, modes, 1), maxval=2 * jnp.pi),
            jax.random.uniform(k_phx, (batch, modes, 1), maxval=2 * jnp.pi))


def inflow_draws(key, batch: int, w: int, x_range=(0.15, 0.85)):
    """`random_inflow`'s source positions (B, 1, 1) from `key`."""
    import jax

    return jax.random.uniform(key, (batch, 1, 1), minval=x_range[0] * w,
                              maxval=x_range[1] * w)


def _centres(key, batch: int, h: int, w: int, margin: int):
    """The shape families' centres (B, 2) as (y, x) from `key`, drawn as
    (B, 2, 1, 1) in [margin, h - margin) x [margin, w - margin)."""
    import jax
    import jax.numpy as jnp

    pos = jax.random.uniform(
        key, (batch, 2, 1, 1), minval=float(margin),
        maxval=jnp.array([[h - margin], [w - margin]],
                         jnp.float32)[None, :, :, None])
    return pos.reshape(batch, 2)


def _uniform(key, batch: int, lo: float, hi: float):
    import jax

    return jax.random.uniform(key, (batch, 1, 1), minval=lo, maxval=hi)


def shape_draws(key, batch: int, h: int, w: int, size_range=(5.0, 10.0),
                margin: int = 12):
    """`random_shape_densities`' draws from `key`: centres (B, 2), r and
    aspect (B, 1, 1), is_circle (B, 1, 1) bool."""
    import jax

    margin = min(margin, h // 4, w // 4)
    k_pos, k_size, k_kind, k_ar = jax.random.split(key, 4)
    return (_centres(k_pos, batch, h, w, margin),
            _uniform(k_size, batch, *size_range),
            _uniform(k_ar, batch, 0.6, 1.6),
            jax.random.bernoulli(k_kind, 0.5, (batch, 1, 1)))


def cross_draws(key, batch: int, h: int, w: int, size_range=(5.0, 10.0),
                margin: int = 12):
    """`random_cross_densities`' draws from `key`: centres (B, 2), arm
    lengths and thickness fractions (B, 1, 1)."""
    import jax

    margin = min(margin, h // 4, w // 4)
    k_pos, k_size, k_t = jax.random.split(key, 3)
    return (_centres(k_pos, batch, h, w, margin),
            _uniform(k_size, batch, *size_range),
            _uniform(k_t, batch, 0.25, 0.45))


def ring_draws(key, batch: int, h: int, w: int, size_range=(6.0, 10.0),
               margin: int = 12):
    """`random_ring_densities`' draws from `key`: centres (B, 2), outer
    radii and inner-radius fractions (B, 1, 1)."""
    import jax

    margin = min(margin, h // 4, w // 4)
    k_pos, k_size, k_in = jax.random.split(key, 3)
    return (_centres(k_pos, batch, h, w, margin),
            _uniform(k_size, batch, *size_range),
            _uniform(k_in, batch, 0.4, 0.65))


def blob_draws(key, batch: int, h: int, w: int, sigma_range=(4.0, 8.0),
               margin: int = 8):
    """`random_smoke_blobs`' draws from `key`: centres (B, 2) as (y, x) and
    widths (B, 1, 1)."""
    import jax
    import jax.numpy as jnp

    margin = min(margin, h // 4, w // 4)
    k_pos, k_sig = jax.random.split(key)
    pos = jax.random.uniform(
        k_pos, (batch, 2), minval=jnp.array([margin, margin], jnp.float32),
        maxval=jnp.array([h - margin, w - margin], jnp.float32))
    return pos, _uniform(k_sig, batch, *sigma_range)


# init family -> its draws and their names in the files.
FAMILIES = {"shapes": (shape_draws, ("pos", "r", "aspect", "is_circle")),
            "blobs": (blob_draws, ("pos", "sig")),
            "crosses": (cross_draws, ("pos", "arm", "thick_frac")),
            "rings": (ring_draws, ("pos", "r_out", "in_frac"))}


def burgers_draws(key, batch: int, modes: int = 3):
    """`random_burgers_states`' draws from `key`: unit-normal amplitudes
    and phases in [0, 2π), (B, M) each."""
    import jax
    import jax.numpy as jnp

    k_amp, k_phase = jax.random.split(key)
    return (jax.random.normal(k_amp, (batch, modes)),
            jax.random.uniform(k_phase, (batch, modes), maxval=2 * jnp.pi))


def chunk_draws(kind: str, seed: int, num: int, h: int, chunk: int,
                init: str | None = None, x_range=(0.15, 0.85)) -> dict:
    """The draws of every chunk of one dataset, stacked along a leading
    axis, as numpy arrays: `kind` 'burgers', 'inflow' (sources in
    `x_range`) or 'forced' (`init`'s family)."""
    import jax

    assert num % chunk == 0, (num, chunk)
    out: dict = {}

    def add(**arrays):
        for k, v in arrays.items():
            out.setdefault(k, []).append(np.asarray(v))

    key = jax.random.PRNGKey(seed)
    for _ in range(num // chunk):
        if kind == "burgers":
            key, k1, k2 = jax.random.split(key, 3)
            for k in (k1, k2):
                add(**dict(zip(("amps", "phases"), burgers_draws(k, chunk))))
            continue
        if kind == "inflow":
            key, k1, k2 = jax.random.split(key, 3)
            add(xs=inflow_draws(k1, chunk, h, x_range))
            fields = (k2,)
        else:
            key, k1, k2, k3 = jax.random.split(key, 4)
            draw, names = FAMILIES[init]
            add(**dict(zip(names, draw(k1, chunk, h, h))))
            fields = (k2, k3)
        for k in fields:
            add(**dict(zip(("amps", "phy", "phx"), smooth_field_draws(k, chunk))))
    return {k: np.stack(v) for k, v in out.items()}


def ood_data(name: str) -> dict:
    """The arrays and `config` of OOD_FILES[name]."""
    size, chunk, num, cases = OOD_FILES[name]
    data, splits = {}, {}
    for case, c in cases.items():
        init = c.get("init")
        x_range = c.get("inflow_kwargs", {}).get("x_range", (0.15, 0.85))
        splits[case] = dict(c, num=num,
                            kinds=[init or "inflow", "field"])
        for k, v in chunk_draws("forced" if init else "inflow", c["seed"],
                                num, size, chunk, init, x_range).items():
            data[f"{case}/{k}"] = v
    data["config"] = json.dumps(dict(config=name, size=size, chunk=chunk,
                                     splits=splits))
    return data


def savez_if_changed(path: str, data: dict) -> bool:
    """`np.savez_compressed(path, **data)`, unless the file there already
    holds the same arrays, bit for bit, under the same names (a zip
    written anew differs in its timestamps alone). Returns whether it
    wrote."""
    if os.path.exists(path):
        with np.load(path) as old:
            if set(old.files) == set(data) and all(
                    old[k].dtype == np.asarray(data[k]).dtype
                    and old[k].shape == np.shape(data[k])
                    and old[k].tobytes() == np.asarray(data[k]).tobytes()
                    for k in data):
                print(f"{path}: unchanged ({os.path.getsize(path)} bytes)",
                      flush=True)
                return False
    np.savez_compressed(path, **data)
    print(f"wrote {path}: {os.path.getsize(path)} bytes", flush=True)
    return True


def main() -> None:
    sys.path.insert(0, ROOT)
    for name, (size, chunk, splits) in FILES.items():
        data = {"config": json.dumps(dict(
            config=int(name[-1]) if name != "burgers" else name, size=size,
            chunk=chunk, splits={s: dict(seed=seed, num=num)
                                 for s, (seed, num) in splits.items()}))}
        kind, init = KINDS[name]
        for split, (seed, num) in splits.items():
            for k, v in chunk_draws(kind, seed, num, size, chunk,
                                    init).items():
                data[f"{split}/{k}"] = v
        savez_if_changed(os.path.join(GOLDENS, f"jax_draws_{name}.npz"), data)
    for name in OOD_FILES:
        data = ood_data(name)
        if name == "ood_shapes":  # config 3's validation set, drawn again
            with np.load(os.path.join(GOLDENS, "jax_draws_config3.npz")) as f:
                val = {k.split("/")[1]: f[k] for k in f.files
                       if k.startswith("val/")}
            ours = {k.split("/")[1]: v for k, v in data.items()
                    if k.startswith("shapes/")}
            if ours.keys() != val.keys() or any(
                    not np.array_equal(ours[k], val[k]) for k in val):
                raise AssertionError("the `shapes` case's draws are not "
                                     "config 3's validation set's")
        savez_if_changed(os.path.join(GOLDENS, f"jax_draws_{name}.npz"), data)


if __name__ == "__main__":
    main()
