"""Writes the JAX package's random draws for the datasets of BASELINE configs
4 and 3, in the port's `*_draws` layouts, so that the port can generate the
JAX package's own training and validation sets on a machine without JAX.

    JAX_PLATFORMS=cpu python scripts/make_jax_draws.py

The datasets themselves (config 4: 512 + 32 trajectories of 17 frames at
64²) are hundreds of MB; their draws are a few KB. This script repeats the
JAX package's key splits, chunk by chunk, at the seeds of the two setups
(train 0, val 999; `pde_control_tpu/experiments/fluid2d.py ::
_smoke_indirect_setup, _shape_transition_setup`), at 64² and 8 trajectories
a chunk (`generate_*_dataset(batch=8)`):

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
  then fx) in `<split>/amps`, `phy`, `phx`.

The layouts are those of `pde_control_tpu_torch/data/generate.py ::
inflow_draws, shape_draws, smooth_field_draws`; fed through the matching
`*_from_draws` they give the JAX generators' fields (within 1e-6,
`tests/test_torch_fullsize.py`). `config` holds the grid, the chunk size,
the seeds and the counts as JSON. `scripts/quality_torch.py` replaces the
port's draw functions by pops from these files.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
SIZE, CHUNK = 64, 8
# The reference runs' counts (scripts/run_quality11.sh): 512 training
# trajectories; the setups' 32 validation ones.
SPLITS = {"train": (0, 512), "val": (999, 32)}


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


def shape_draws(key, batch: int, h: int, w: int, size_range=(5.0, 10.0),
                margin: int = 12):
    """`random_shape_densities`' draws from `key`: centres (B, 2), r and
    aspect (B, 1, 1), is_circle (B, 1, 1) bool."""
    import jax
    import jax.numpy as jnp

    margin = min(margin, h // 4, w // 4)
    k_pos, k_size, k_kind, k_ar = jax.random.split(key, 4)
    pos = jax.random.uniform(
        k_pos, (batch, 2, 1, 1), minval=float(margin),
        maxval=jnp.array([[h - margin], [w - margin]],
                         jnp.float32)[None, :, :, None])
    return (pos.reshape(batch, 2),
            jax.random.uniform(k_size, (batch, 1, 1), minval=size_range[0],
                               maxval=size_range[1]),
            jax.random.uniform(k_ar, (batch, 1, 1), minval=0.6, maxval=1.6),
            jax.random.bernoulli(k_kind, 0.5, (batch, 1, 1)))


def chunk_draws(config: int, seed: int, num: int, h: int = SIZE,
                chunk: int = CHUNK) -> dict:
    """The draws of every chunk of one dataset, stacked along a leading
    axis: {'xs' or 'pos', 'r', 'aspect', 'is_circle'; 'amps', 'phy',
    'phx'} as numpy arrays."""
    import jax

    assert num % chunk == 0, (num, chunk)
    out: dict = {}

    def add(**arrays):
        for k, v in arrays.items():
            out.setdefault(k, []).append(np.asarray(v))

    key = jax.random.PRNGKey(seed)
    for _ in range(num // chunk):
        if config == 4:
            key, k1, k2 = jax.random.split(key, 3)
            add(xs=inflow_draws(k1, chunk, h))
            fields = (k2,)
        else:
            key, k1, k2, k3 = jax.random.split(key, 4)
            pos, r, aspect, is_circle = shape_draws(k1, chunk, h, h)
            add(pos=pos, r=r, aspect=aspect, is_circle=is_circle)
            fields = (k2, k3)
        for k in fields:
            add(**dict(zip(("amps", "phy", "phx"), smooth_field_draws(k, chunk))))
    return {k: np.stack(v) for k, v in out.items()}


def main() -> None:
    sys.path.insert(0, ROOT)
    for config in (4, 3):
        data = {"config": json.dumps(dict(
            config=config, size=SIZE, chunk=CHUNK,
            splits={s: dict(seed=seed, num=num)
                    for s, (seed, num) in SPLITS.items()}))}
        for split, (seed, num) in SPLITS.items():
            for k, v in chunk_draws(config, seed, num).items():
                data[f"{split}/{k}"] = v
        out = os.path.join(GOLDENS, f"jax_draws_config{config}.npz")
        np.savez_compressed(out, **data)
        print(f"wrote {out}: {os.path.getsize(out)} bytes", flush=True)


if __name__ == "__main__":
    main()
