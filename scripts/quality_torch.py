"""Trains a BASELINE config with the port at the JAX package's published
counts, and prints the result beside the JAX package's.

    python3 scripts/quality_torch.py config1|config2|config3|config4|config5 [--draws jax|port]
    python3 scripts/quality_torch.py compare_burgers
    python3 scripts/quality_torch.py config3|config4 --ood [--route kernel]

The counts are those of the JAX package's published runs, seed 0, on the
entries' default routes:
* config 1 (`burgers.run_chain_supervised`): 2,000 iterations, 1,024 +
  128 trajectories, batch 32 (the entry's defaults); reference the row of
  `RESULTS.md` (no `results.json` was kept);
* config 2 (`burgers.run_hierarchical`): 1,000 iterations a stage, 1,024
  + 128, batch 32; reference `artifacts/runs/burgers_hierarchical`;
* config 3: `--iterations 3500 --num-train 512`, and config 4:
  `--iterations 4000 --e2e-iterations 8000 --num-train 512`, 32
  validation trajectories (`scripts/run_quality11.sh`); references the
  seeds 0, 1 and 2 of `artifacts/runs/{shape_transition,smoke_indirect}`;
* config 5 (`fluid2d.run_natural_flow_128`): 300 iterations a supervised
  stage, 4,500 at each e2e horizon (32, 64, 128), 3,584 + 64
  trajectories, batch 8, through the disk cache
  (`scripts/run_queue_r3c.sh`), here `<run>/data`; reference
  `artifacts/runs/natural_flow_128_final`. Its data take ~9 GB on disk
  and ~15 min to make on an H100, and the whole run more than an hour.
* `compare_burgers` (`compare_schemes.compare_burgers`, the paper's
  scheme table): 1,000 iterations a stage (the CFE, OP2 ... OP32, then an
  e2e stage per scheme), 500 adjoint iterations, 1,024 + 128
  trajectories, batch 32 (the entry's defaults); reference
  `artifacts/runs/compare_burgers/comparison.json`.
Every stage runs 8 steps a call, so 300 and 4,500 become 304 and 4,504,
as in the JAX package's runs.

* `--draws jax` (the default) trains on the JAX package's own datasets:
  the port's draw functions (`data/generate.py :: burgers_draws,
  inflow_draws, smooth_field_draws`, and the draws of the `INITS`
  families) are replaced, for the run, by pops from
  `tests/goldens/jax_draws_{burgers,config3,config4,config5}.npz`
  (`scripts/make_jax_draws.py`), chunk by chunk, the training set's from
  the generator seeded 0 and the validation set's from the one seeded
  999; a pop past the file's end, or a draw the run's counts need and did
  not pop, is an error. The run is in `runs/quality_torch/<config>_jax`.
  The zero-force MSE must then equal the JAX package's (within 1e-4
  relative for Burgers, 1e-2 for the smoke configs): that holds the data
  path.
* `--draws port` runs the port's CLI, unpatched, in a subprocess, as a
  user would (`python -m pde_control_tpu_torch.experiments.run
  smoke_indirect …` into `runs/quality_torch/config4_port`): the port's
  own draws, so the data differs from the JAX package's and only the
  controlled / zero-force ratio compares.

Printed: the card's name and power limit (`nvidia-smi`), the bytes and
dtype of each dataset put on the device, each stage's final training
loss, steps/s and iterations run beside the JAX package's, the eval block
(controlled final MSE ± sem, zero force, ratio, mean |F|) beside theirs,
whether the controlled MSE lies within the band around the JAX runs'
mean (configs 1-3 ±25%, config 4 ±15%, config 5 ±30%) and, with the JAX
draws, whether the zero force matches; the wall time; and last a JSON
summary line, also written to `summary.json` in the run directory. The
exit code is 0 once the run has finished, whatever the comparison says.

With `--draws port --cross-eval` (configs 3 and 4), the run's final
networks are evaluated again on the JAX package's validation set (its
draws), which tells a harder validation set from a worse controller.

`compare_burgers` prints each stage's final loss and steps/s, then the
rows chain_final, staggered, refined, adjoint and zero_force (controlled
final MSE ± sem, mean |F|, force cost) beside `comparison.json`'s, the
ratios chain/staggered and staggered/adjoint, the launches of K1-K5 in
the run (Burgers runs none), and its checks (`scheme_checks`): each zero
force within 1e-4 relative of the JAX package's (the scheme rows' over
128 samples, the `zero_force` row's over the first 32), the adjoint row
within 5%, each scheme row against ±25% around its JAX value (a miss is
recorded with its side and sem, not re-run), and the paper's order:
chain_final the worst scheme by at least 3x, the adjoint below every
scheme.

`--ood` (configs 3 and 4, `--draws jax`): after the training run's eval,
the run's `ckpt_final` goes through the port's out-of-distribution entry
(`generalize.generalize_shapes` for config 3, `generalize_smoke` for
config 4, on their own route) into `<run>/ood`, on the JAX package's
draws of those sets (`tests/goldens/jax_draws_ood_{shapes,smoke}.npz`).
Each row (controlled final MSE ± sem, zero force, ratio, mean |F|) is
printed beside the JAX package's runs (`generalize_shapes` and
`generalize_shapes_s0r5`; `generalize_smoke`), with its checks
(`ood_checks`): every zero force within 1e-2 relative of the JAX
package's; the in-distribution row (`shapes`, `in_dist`) equal to the
same nets' eval on the same validation set on the same route (on
`--route kernel`, an eval of `ckpt_final` on the default route, made
here), with the gap to the training run's own eval printed beside it;
each controlled row against ±25% around the JAX runs' mean where there
are two runs, ±30% where there is one; the chain_final rows by MSE and
ratio alone; and `RESULTS.md`'s findings (shapes > crosses > rings by
ratio; obstacles_ood within 1.5x of in_dist's ratio; inflow_shifted below
5x) as true or false.

A run longer than one call of the chip (config 5) is split over calls
by its stage checkpoints (`run_curriculum(resume=True)` skips every stage
whose checkpoint exists and restores a mid-stage autosave):
* `--save-to DIR` copies each stage checkpoint (`ckpt_*`, but
  `ckpt_final`) and each autosave (`autosave_*`, dropped once its stage's
  checkpoint is there) into DIR as it is written, with the stages'
  results (`stages.json`) and the datasets' digests (`digests.json`), so
  that a call cut by a time limit still leaves them. At config 5's widths
  the four checkpoints that e2e n = 128 resumes from take ~51 MB, an
  autosave of that stage ~60 MB;
* `--stop-after STAGE` (a key of `results.json`: `cfe_supervised`,
  `op2_supervised` ... `end_to_end_n64`) ends the call cleanly once that
  stage's checkpoint is written;
* `--resume-from DIR` starts from an earlier call's DIR: its `ckpt_*` and
  `autosave_*` are copied into the run directory, the data is made again
  from the same draws, each dataset's digest must equal the earlier
  call's, and the run resumes; the earlier calls' stage results are
  printed beside this call's. A mid-stage resume sees another batch order
  than an unbroken stage;
* `--no-render` leaves out the log points' PNG renders (an eager rollout
  at the stage's n each), and says so.
Every call prints the digest (sha256 of the arrays) of the training and
validation sets.

`--iterations`, `--e2e-iterations`, `--num-train`, `--num-val`,
`--adjoint-iterations` (compare_burgers) and `--device` cut a quick check
(the comparison is then not meaningful); with `--draws jax` the counts
must be multiples of the draws' chunk (8; 64 for Burgers). `--num-val`
also cuts the `--ood` rows, whose draws are at 64², n = 16.

`--seed N` (configs 3-5, `--draws jax`) trains at another seed, as the
JAX package's runs at seeds 1 and 2 did (the CLI's `--seed`), into
`<run>_sN`; the comparison is against the same JAX runs.

`--route kernel` (configs 4 and 5, with `--draws jax`) trains on every
kernel of the port, the route of `scripts/config5_routes.py :: ROUTES`:
the setup (`fluid2d._smoke_indirect_setup`, `_natural_flow_setup`) is
called with `fused='cuda', conv_impl='cuda'`, so that the fused step and
its VJP (K2/K3) and the hand-written 3×3 convs (K4/K5) train, and on
config 5 also `pressure_backend='cuda'`, so that the PCG kernel (K1)
makes the data in place of the exact spectral solve (part of the data's
cache key) and the fused step may run there. Config 4's data is made on
its default route whatever `fused` says (K1 on the plate), so its digest
is the default route's. The entries themselves are not changed. The run
is in `runs/quality_torch/<config>_jax_kernel`. Beside the default
route's prints, the data and each stage print their launches of each
kernel (the delta of `ops.launch_counts()`: eager calls and graph
captures), and each stage its `notfinite_total` and iterations a second
beside the default route's full-count run (`DEFAULT_ROUTE_RUNS`). On the
card a stage that launched none of the kernels its class runs (K2-K5 in
the CFE and e2e stages, K4/K5 in the OP stages), or data made without
K1, stops the run with an error (`RouteNotTaken`): the route did not
run. After the eval the stages' losses and pace are printed beside the
default route's, and the controlled MSE beside its run's. The summary
says `"route": "kernel"`.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
RUNS = os.path.join(ROOT, "artifacts", "runs")
# config: the CLI entry, the JAX package's runs (seeds 0, 1, 2 where there
# are three), the reference counts, the band around their mean controlled
# MSE, the draws' file and the zero force's relative tolerance.
CONFIGS = {
    "config1": dict(entry="burgers_chain", refs=(),
                    counts=dict(iterations=2000, e2e_iterations=None,
                                num_train=1024, num_val=128),
                    band=0.25, draws="burgers", zero_rtol=1e-4),
    "config2": dict(entry="burgers_hierarchical",
                    refs=("burgers_hierarchical",),
                    counts=dict(iterations=1000, e2e_iterations=None,
                                num_train=1024, num_val=128),
                    band=0.25, draws="burgers", zero_rtol=1e-4),
    "config3": dict(entry="shape_transition",
                    refs=("shape_transition", "shape_transition_s1",
                          "shape_transition_s2"),
                    counts=dict(iterations=3500, e2e_iterations=None,
                                num_train=512, num_val=32),
                    band=0.25, draws="config3", zero_rtol=1e-2),
    "config4": dict(entry="smoke_indirect",
                    refs=("smoke_indirect", "smoke_indirect_s1",
                          "smoke_indirect_s2"),
                    counts=dict(iterations=4000, e2e_iterations=8000,
                                num_train=512, num_val=32),
                    band=0.15, draws="config4", zero_rtol=1e-2),
    "config5": dict(entry="natural_flow_128", refs=("natural_flow_128_final",),
                    counts=dict(iterations=300, e2e_iterations=4500,
                                num_train=3584, num_val=64),
                    band=0.30, draws="config5", zero_rtol=1e-2),
    "compare_burgers": dict(entry="compare_burgers", refs=("compare_burgers",),
                            counts=dict(iterations=1000, e2e_iterations=None,
                                        num_train=1024, num_val=128,
                                        adjoint_iterations=500),
                            band=0.25, draws="burgers", zero_rtol=1e-4),
}
# `compare_burgers`: its scheme rows, the adjoint row's tolerance around the
# JAX package's (it trains no net: the draws, lr, force_reg and Adam steps
# alone set it), and the paper's order (chain_final worse than the other
# schemes by at least this factor).
SCHEMES = ("chain_final", "staggered", "refined")
ADJOINT_RTOL = 0.05
CHAIN_FACTOR = 3.0
# `--ood`: each config's out-of-distribution entry, the draws file of its
# sets, the JAX package's runs of it (`artifacts/runs`), how many sets the
# entry makes from each case's draws (generalize_smoke makes `in_dist`
# twice: its staggered and its chain_final rows), its in-distribution
# row, and the in-distribution row's tolerance against the same nets' eval
# on the same route.
OOD = {
    "config3": dict(entry="generalize_shapes", draws="ood_shapes",
                    refs=("generalize_shapes", "generalize_shapes_s0r5"),
                    sets={}, in_dist="shapes"),
    "config4": dict(entry="generalize_smoke", draws="ood_smoke",
                    refs=("generalize_smoke",), sets={"in_dist": 2},
                    in_dist="in_dist"),
}
OOD_ZERO_RTOL = 1e-2
OOD_IN_DIST_RTOL = 1e-4
# The bands: ±25% around the mean of two JAX runs, ±30% around one.
OOD_BANDS = {1: 0.30, 2: 0.25}
# The route gap measured on config 4's zero force at full counts (the eval's
# physics on K2 against K1; PERF.md §6), printed beside this run's.
ROUTE_GAP_ZERO = 4.76e-4
# Config 1's published result (`RESULTS.md`, the table of the post-reset
# regenerations, row 1): its run kept no `results.json`. Its zero force is
# config 2's run's, on the same validation set (`burgers.make_datasets`:
# the same seeds and counts), to all its digits.
CONFIG1_EVAL = dict(final_state_mse=3.17e-6, final_state_mse_sem=0.22e-6,
                    mean_abs_force=0.29)
STAGES = ("train", "cfe_supervised",
          *(f"op{2 ** k}_supervised" for k in range(1, 8)),
          *(f"end_to_end_n{n}" for n in (32, 64, 128)), "end_to_end")
# The draws' arrays a pop returns, by the port's draw function.
DRAW_KEYS = {"inflow": ("xs",), "field": ("amps", "phy", "phx"),
             "shapes": ("pos", "r", "aspect", "is_circle"),
             "blobs": ("pos", "sig"), "burgers": ("amps", "phases"),
             "crosses": ("pos", "arm", "thick_frac"),
             "rings": ("pos", "r_out", "in_frac")}
# The draw functions each file's datasets call, by its `config` (the OOD
# files name them by split, as `kinds`).
KINDS = {"burgers": ("burgers",), "3": ("shapes", "field"),
         "4": ("inflow", "field"), "5": ("blobs", "field")}
INFLOW_X_RANGE = (0.15, 0.85)  # `inflow_draws`' default
# `--route kernel`: the setup each config's entry calls, and the routes it
# is given there.
KERNEL_ROUTE = {
    "config4": ("_smoke_indirect_setup", dict(fused="cuda", conv_impl="cuda")),
    "config5": ("_natural_flow_setup", dict(fused="cuda", conv_impl="cuda",
                                            pressure_backend="cuda")),
}
# The kernels a stage of each class launches on the kernel route: the
# physics steps (K2/K3) and the nets (K4/K5), or the nets alone.
ALL_KERNELS = ("K2", "K3", "K4 fwd", "K4 dX", "K5")
STAGE_KERNELS = {"op_supervised": ("K4 fwd", "K4 dX", "K5")}
# The default route's full-count runs on the JAX package's draws, on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md §5-§6): the controlled final MSE
# and, by stage, iterations a second and final loss where the run's records
# kept them (config 4's: the CFE and e2e paces alone).
DEFAULT_ROUTE_RUNS = {
    "config4": dict(
        final_state_mse=1.1586e-04,
        steps_per_sec={"cfe_supervised": 13.3, "end_to_end_n16": 12.1},
        loss={}),
    "config5": dict(
        final_state_mse=2.4488e-03,
        steps_per_sec={
            "cfe_supervised": 1.8276, "op2_supervised": 9.2842,
            "op4_supervised": 19.279, "op8_supervised": 37.788,
            "op16_supervised": 73.557, "op32_supervised": 151.34,
            "op64_supervised": 268.19, "op128_supervised": 294.66,
            "end_to_end_n32": 8.1319, "end_to_end_n64": 4.1064,
            "end_to_end_n128": 2.0451},
        loss={
            "cfe_supervised": 7.4094e-02, "op2_supervised": 6.9654e-05,
            "op4_supervised": 4.1885e-05, "op8_supervised": 1.2575e-04,
            "op16_supervised": 2.0716e-04, "op32_supervised": 5.0162e-04,
            "op64_supervised": 3.4010e-03, "op128_supervised": 1.2393e-02,
            "end_to_end_n32": 1.0720e-04, "end_to_end_n64": 4.6436e-04,
            "end_to_end_n128": 1.0301e-02}),
}


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


@contextlib.contextmanager
def patch_draws(name: str):
    """Within the block, the port's draw functions are replaced by pops
    from the JAX package's draws in `tests/goldens/jax_draws_<name>.npz`;
    yields the pops made, by (split, draw function), and the draws file.
    Each generator pops its split's chunks from the first: the split is
    the one whose seed seeded it (an unknown seed is an error that names
    it), and a set made twice from one seed pops its draws twice. An
    inflow set whose sources are drawn in another band than the draws'
    (`inflow_kwargs`' x_range) is an error."""
    import torch

    from pde_control_tpu_torch.data import generate

    with np.load(os.path.join(GOLDENS, f"jax_draws_{name}.npz")) as f:
        z = dict(f)
    meta = json.loads(str(z["config"]))
    split_of = {v["seed"]: split for split, v in meta["splits"].items()}
    pops: dict = {}
    # id(generator) -> (the generator, kept so that its id stays its own;
    # its split; pops by kind)
    gens: dict = {}

    def split_for(gen) -> tuple:
        if id(gen) not in gens:
            seed = gen.initial_seed()
            if seed not in split_of:
                raise KeyError(f"jax_draws_{name}.npz holds no split of seed "
                               f"{seed} (its splits: {split_of})")
            gens[id(gen)] = (gen, split_of[seed], {})
        return gens[id(gen)][1:]

    def pop(gen, kind: str, batch: int):
        split, popped = split_for(gen)
        if batch != meta["chunk"]:
            raise ValueError(f"a chunk of {batch}: the JAX draws come in "
                             f"chunks of {meta['chunk']}")
        i = popped.get(kind, 0)
        have = z[f"{split}/{DRAW_KEYS[kind][0]}"].shape[0]
        if i >= have:
            raise IndexError(f"{split}/{kind}: pop {i + 1} of {have} draws")
        popped[kind] = i + 1
        pops[split, kind] = pops.get((split, kind), 0) + 1
        return tuple(torch.from_numpy(np.array(z[f"{split}/{k}"][i]))
                     for k in DRAW_KEYS[kind])

    def inflow(gen, b, w, x_range=INFLOW_X_RANGE):
        split, _ = split_for(gen)
        want = meta["splits"][split].get("inflow_kwargs", {}).get(
            "x_range", INFLOW_X_RANGE)
        if tuple(x_range) != tuple(want):
            raise ValueError(f"{split}: sources drawn in {tuple(x_range)}, "
                             f"the JAX draws in {tuple(want)}")
        return pop(gen, "inflow", b)[0]

    names = ("smooth_field_draws", "burgers_draws", "inflow_draws")
    saved = [getattr(generate, k) for k in names], dict(generate.INITS)
    generate.smooth_field_draws = lambda gen, b, modes=3: pop(gen, "field", b)
    generate.burgers_draws = lambda gen, b, modes=3: pop(gen, "burgers", b)
    generate.inflow_draws = inflow
    for init in ("shapes", "blobs", "crosses", "rings"):
        generate.INITS[init] = (
            lambda gen, b, h, w, *a, _kind=init, **k: pop(gen, _kind, b),
            generate.INITS[init][1])
    try:
        yield pops, z
    finally:
        for k, f in zip(names, saved[0]):
            setattr(generate, k, f)
        generate.INITS.update(saved[1])


def check_pops(pops: dict, z, counts: dict, sets: dict | None = None
               ) -> None:
    """Every draw the run's counts need was popped, no more: a chunk of
    each split per `chunk` trajectories, times the calls a chunk makes
    (the file's draws over its chunks), times the sets made from the
    split (`sets`, 1 unless given). At the files' own counts that is
    every draw in the file, once a set. A split with no pop at all was
    read from the run's own disk cache (config 5's `<run>/data`)."""
    meta = json.loads(str(z["config"]))
    wanted = {}
    for split, v in meta["splits"].items():
        if not any(s == split for s, _ in pops):
            print(f"{split}: no draws popped (read from the disk cache)")
            continue
        num = counts["num_train" if split == "train" else "num_val"]
        for kind in v.get("kinds") or KINDS[str(meta["config"])]:
            calls = (z[f"{split}/{DRAW_KEYS[kind][0]}"].shape[0]
                     // (v["num"] // meta["chunk"]))
            wanted[split, kind] = (num // meta["chunk"] * calls
                                   * (sets or {}).get(split, 1))
    if pops != wanted:
        raise AssertionError(f"draws popped {sorted(pops.items())}, the "
                             f"counts need {sorted(wanted.items())}")


def report_device_datasets(t0: float) -> None:
    """Prints the bytes and dtype of each dataset as it is put on the
    device (`DeviceDataset.wrap`), and the seconds since `t0`."""
    from pde_control_tpu_torch.data import scene

    wrap = scene.DeviceDataset.wrap.__func__
    seen = set()

    def reporting(cls, ds, device=None):
        view = wrap(cls, ds, device)
        if id(view) not in seen:
            seen.add(id(view))
            if isinstance(view, cls):
                nbytes = sum(t.numel() * t.element_size()
                             for t in view._arrays.values())
                print(f"dataset on {view.device}: {len(view)} trajectories, "
                      f"obs {tuple(view.obs.shape)} {view.obs.dtype}, "
                      f"{nbytes} bytes, {time.perf_counter() - t0:.1f} s "
                      "into the run", flush=True)
            else:
                print(f"dataset of {len(ds)} trajectories kept on the host",
                      flush=True)
        return view

    scene.DeviceDataset.wrap = classmethod(reporting)


def report_stages(t0: float) -> dict:
    """Prints each training stage's class, horizon, iterations, seconds and
    final loss as it ends, and the seconds since `t0`
    (`ControlTraining.train`). Returns a dict that gathers each stage's
    result with its seconds, by `comparison_tag`."""
    from pde_control_tpu_torch.control.training import ControlTraining

    train = ControlTraining.train
    stages: dict = {}

    def reporting(self, iterations, *args, **kwargs):
        t = time.perf_counter()
        out = train(self, iterations, *args, **kwargs)
        stages[comparison_tag(self)] = dict(out, seconds=time.perf_counter() - t)
        print(f"stage {self.sequence_class}, n={self.n}, trains "
              f"{sorted(self.trainable_networks)}: "
              f"{out.get('iterations_run', iterations)} iterations in "
              f"{time.perf_counter() - t:.1f} s, final loss {out.get('loss')}, "
              f"{time.perf_counter() - t0:.1f} s into the run", flush=True)
        return out

    ControlTraining.train = reporting
    return stages


class StopAfterStage(Exception):
    """Raised once the checkpoint of `--stop-after`'s stage is written."""


def stage_tag(app) -> str:
    """The tag of the curriculum stage `app` trains, as `run_curriculum`
    names its autosave (`autosave_<tag>`): `cfe`, `op<span>`, `e2e_n<n>`."""
    if app.sequence_class == "chain":
        return "cfe"
    if app.sequence_class == "op_supervised":
        return app.trainable_networks[0].lower()
    return f"e2e_n{app.n}"


def comparison_tag(app) -> str:
    """`stage_tag`, but `e2e_<scheme>` for a scheme's e2e stage, as
    `run_comparison` names its autosaves."""
    if app.sequence_class in SCHEMES:
        return f"e2e_{app.sequence_class}"
    return stage_tag(app)


def stage_key(app) -> str:
    """The `results.json` key of the curriculum stage `app` trains."""
    tag = stage_tag(app)
    if tag.startswith(("cfe", "op")):
        return f"{tag}_supervised"
    return f"end_to_end_n{app.n}"


def dataset_digest(ds) -> str:
    """sha256 of a trajectory dataset's arrays (names, shapes, dtypes and
    bytes), read in chunks of ~64 MB."""
    h = hashlib.sha256()
    for name, a in [("obs", ds.obs), *sorted(ds.extras.items())]:
        a = np.asarray(a)
        h.update(f"{name} {a.shape} {a.dtype};".encode())
        step = max(1, (64 << 20) // max(1, a[:1].nbytes))
        for i in range(0, len(a), step):
            h.update(memoryview(np.ascontiguousarray(a[i:i + step])))
    return h.hexdigest()


def _mirror(src: str, dst: str) -> None:
    """Copy the directory `src` to `dst` through a temporary sibling, so
    that a kill leaves `dst` (or its `.old`) whole."""
    tmp, old = dst + ".tmp", dst + ".old"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.copytree(src, tmp)
    shutil.rmtree(old, ignore_errors=True)
    if os.path.isdir(dst):
        os.replace(dst, old)
    os.replace(tmp, dst)
    shutil.rmtree(old, ignore_errors=True)


def _write_json(path: str, obj) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f, indent=1, default=float)
    os.replace(path + ".tmp", path)


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


@contextlib.contextmanager
def split_run(workdir: str, save_to: str | None = None,
              stop_after: str | None = None, resume_from: str | None = None,
              render: bool = True):
    """Hooks that split a curriculum run over calls (module docstring):
    within the block, each fluid dataset's digest is printed (and held to
    `resume_from`'s), each stage checkpoint and autosave is copied into
    `save_to` as it is written, and `StopAfterStage` is raised once
    `stop_after`'s checkpoint is written. With `resume_from`, its
    `ckpt_*` and `autosave_*` are first copied into `workdir`. Yields a
    dict: the digests, the stage results of this call and of the earlier
    ones (`earlier`)."""
    from pde_control_tpu_torch.control.training import ControlTraining
    from pde_control_tpu_torch.experiments import fluid2d
    from pde_control_tpu_torch.experiments.curriculum import clear_autosave

    state = {"digests": {}, "stages": {}, "earlier": {}, "earlier_digests": {}}
    if resume_from:
        os.makedirs(workdir, exist_ok=True)
        names = set(os.listdir(resume_from))
        for name in sorted(names):
            base = name.removesuffix(".old")
            # A `.old` stands in for its copy only where a kill took that.
            if (not name.startswith(("ckpt_", "autosave_"))
                    or name.endswith(".tmp") or (name != base and base in names)):
                continue
            shutil.copytree(os.path.join(resume_from, name),
                            os.path.join(workdir, base), dirs_exist_ok=True)
            print(f"resume: {base} from {os.path.join(resume_from, name)}",
                  flush=True)
        state["earlier"] = _read_json(os.path.join(resume_from, "stages.json"))
        state["earlier_digests"] = _read_json(
            os.path.join(resume_from, "digests.json"))
    if save_to:
        os.makedirs(save_to, exist_ok=True)
        if resume_from and os.path.abspath(resume_from) != os.path.abspath(
                save_to):
            # The earlier calls' records travel on with this call's.
            _write_json(os.path.join(save_to, "stages.json"),
                        state["earlier"])
    cached = fluid2d._maybe_cached
    train, save, autosave = (ControlTraining.train, ControlTraining.save,
                             ControlTraining.autosave)
    render_progress = ControlTraining._render_progress

    def digesting(datadir, split, params, build):
        ds = cached(datadir, split, params, build)
        d = state["digests"][split] = dataset_digest(ds)
        was = state["earlier_digests"].get(split)
        print(f"{split} set: {len(ds)} trajectories, digest sha256 {d}"
              + (f", the earlier call's {'the same' if was == d else was}"
                 if resume_from else ""), flush=True)
        if resume_from and was != d:
            raise AssertionError(f"the {split} set's digest {d} is not the "
                                 f"earlier call's {was}")
        if save_to:
            _write_json(os.path.join(save_to, "digests.json"),
                        state["digests"])
        return ds

    def training(self, iterations, *args, **kwargs):
        out = train(self, iterations, *args, **kwargs)
        self._split_result = out
        return out

    def saving(self, directory, names=None):
        save(self, directory, names)
        key, final = stage_key(self), os.path.basename(directory) == "ckpt_final"
        if hasattr(self, "_split_result"):
            state["stages"][key] = self._split_result
            if save_to:
                _write_json(os.path.join(save_to, "stages.json"),
                            {**state["earlier"], **state["stages"]})
        if save_to and not final:
            # A stage's checkpoint replaces its autosave (as run_curriculum
            # drops it), and `ckpt_final` repeats the last stage's: what a
            # later call needs stays small (~51 MB at config 5's widths).
            _mirror(directory, os.path.join(save_to,
                                            os.path.basename(directory)))
            clear_autosave(save_to, stage_tag(self))
        if key == stop_after and not final:
            raise StopAfterStage(key)

    def autosaving(self, directory):
        autosave(self, directory)
        if save_to:
            _mirror(directory, os.path.join(save_to,
                                            os.path.basename(directory)))

    fluid2d._maybe_cached = digesting
    ControlTraining.train, ControlTraining.save = training, saving
    ControlTraining.autosave = autosaving
    if not render:
        print("the log points' PNG renders are left out (--no-render)",
              flush=True)
        ControlTraining._render_progress = lambda self, batch: None
    try:
        yield state
    finally:
        fluid2d._maybe_cached = cached
        ControlTraining.train, ControlTraining.save = train, save
        ControlTraining.autosave = autosave
        ControlTraining._render_progress = render_progress


class RouteNotTaken(RuntimeError):
    """A kernel of the kernel route was not launched where it must be."""


def _launch_delta(before: dict) -> dict:
    from pde_control_tpu_torch.ops import launch_counts

    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


@contextlib.contextmanager
def kernel_route(config: str, device: str = "cuda"):
    """`--route kernel` (module docstring): within the block, `config`'s
    setup is called with the kernel route, and the data and each stage
    print their launches by kernel; each stage also its `notfinite_total`
    and pace beside the default route's run; a stage's launches go into
    its result (`launches`). Where `device` is a card, a kernel the data
    or a stage must launch and did not raises `RouteNotTaken` (the
    wrappers count only there: on the CPU they run the kernels' plain
    versions). Yields a dict whose `data` holds the data's launches and
    the sets it made."""
    from pde_control_tpu_torch.control.training import ControlTraining
    from pde_control_tpu_torch.experiments import fluid2d
    from pde_control_tpu_torch.ops import launch_counts

    name, route = KERNEL_ROUTE[config]
    setup, train = getattr(fluid2d, name), ControlTraining.train
    counted = str(device).startswith("cuda")
    ref = DEFAULT_ROUTE_RUNS[config]["steps_per_sec"]
    state = {"data": {}}

    def require(where: str, launches: dict, kernels) -> None:
        missing = [k for k in kernels if not launches[k]]
        if counted and missing:
            raise RouteNotTaken(f"{where} launched no {', '.join(missing)} on "
                                f"the kernel route: {launches}")

    def routed_setup(*args, **kwargs):
        cached, seen, built = fluid2d._maybe_cached, [], []

        def building(datadir, split, params, build):
            seen.append(split)
            return cached(datadir, split, params,
                          lambda: built.append(split) or build())

        fluid2d._maybe_cached = building
        before = launch_counts()
        try:
            out = setup(*args, **{**kwargs, **route})
        finally:
            fluid2d._maybe_cached = cached
        launches = _launch_delta(before)
        state["data"] = dict(launches=launches, generated=built)
        cache = [split for split in seen if split not in built]
        print(f"route kernel, data: made {built or 'none'}, read from the "
              f"disk cache {cache or 'none'}; launches {launches}", flush=True)
        if built:
            require("the data", launches, ("K1",))
        return out

    def training(self, iterations, *args, **kwargs):
        before = launch_counts()
        out = train(self, iterations, *args, **kwargs)
        if out.get("resumed_mid_stage", -1) >= out.get("iterations_run", 0):
            return out  # its autosave had every iteration: nothing ran
        key = stage_key(self)
        # In the stage's result, so that a later call's records keep it.
        launches = out["launches"] = _launch_delta(before)
        print(f"route kernel, stage {key}: launches {launches}, "
              f"notfinite_total {out.get('notfinite_total')}, "
              f"{out['steps_per_sec']:.3f} it/s, the default route's "
              f"{ref.get(key) or 'not recorded'}", flush=True)
        require(f"stage {key}", launches,
                STAGE_KERNELS.get(self.sequence_class, ALL_KERNELS))
        return out

    setattr(fluid2d, name, routed_setup)
    ControlTraining.train = training
    try:
        yield state
    finally:
        setattr(fluid2d, name, setup)
        ControlTraining.train = train


def compare_default_route(config: str, summary: dict, results: dict,
                          data: dict) -> None:
    """Prints the kernel route's stages (this call's and the earlier
    calls') and eval beside the default route's full-count run, and adds
    the route's records to `summary`."""
    ref = DEFAULT_ROUTE_RUNS[config]
    nan = float("nan")
    stages = [s for s, v in results.items() if s != "end_to_end"
              and isinstance(v, dict) and "launches" in v]
    print(f"{'stage':<18} {'kernel loss':>12} {'default':>12} "
          f"{'kernel it/s':>11} {'default':>8} {'notfinite':>9}")
    for stage in stages:
        got = results[stage]
        print(f"{stage:<18} {got.get('loss', nan):>12.4e} "
              f"{ref['loss'].get(stage, nan):>12.4e} "
              f"{got.get('steps_per_sec', nan):>11.3f} "
              f"{ref['steps_per_sec'].get(stage, nan):>8.3f} "
              f"{got.get('notfinite_total')!s:>9}")
    mse = summary["final_state_mse"]
    print(f"controlled final MSE {mse:.4e}, the default route's run "
          f"{ref['final_state_mse']:.4e} ({mse / ref['final_state_mse']:.3f}x)",
          flush=True)
    summary.update(
        route="kernel", route_data=data,
        route_stages={s: {k: results[s].get(k) for k in (
            "launches", "notfinite_total", "steps_per_sec")} for s in stages},
        default_route=ref)


def merge_earlier(results: dict, earlier: dict) -> dict:
    """`results` with each stage that this call skipped (`resumed`) taken
    from the earlier calls' records, marked `from_earlier_call`."""
    out = dict(results)
    for key, rec in earlier.items():
        if out.get(key, {}).get("resumed") and isinstance(rec, dict):
            out[key] = dict(rec, from_earlier_call=True)
    return out


def run_jax_draws(config: str, counts: dict, device: str, workdir: str,
                  resume: bool = False, seed: int = 0) -> dict:
    kw = dict(iterations=counts["iterations"], num_train=counts["num_train"],
              num_val=counts["num_val"], device=device)
    stopped = results = None
    with patch_draws(CONFIGS[config]["draws"]) as (pops, z):
        try:
            results = _run_entry(config, counts, workdir, resume, kw, seed)
        except StopAfterStage as e:  # the data was all made: check its draws
            stopped = e
    print(f"draws popped from jax_draws_{CONFIGS[config]['draws']}.npz: "
          f"{ {f'{s}/{k}': n for (s, k), n in sorted(pops.items())} }",
          flush=True)
    check_pops(pops, z, counts)
    if stopped:
        raise stopped
    return results


def _run_entry(config: str, counts: dict, workdir: str, resume: bool,
               kw: dict, seed: int = 0) -> dict:
    from pde_control_tpu_torch.experiments import burgers, fluid2d

    if config == "config1":  # the CLI writes this entry's results.json
        results = burgers.run_chain_supervised(workdir, **kw)
        with open(os.path.join(workdir, "results.json"), "w") as f:
            json.dump(results, f, indent=2, default=float)
    elif config == "config2":
        results = burgers.run_hierarchical(workdir, **kw)
    elif config == "compare_burgers":
        results = _compare_burgers(workdir, counts, resume, kw)
    elif config == "config3":
        results = fluid2d.run_shape_transition(workdir, seed=seed,
                                               resume=resume, **kw)
    elif config == "config4":
        results = fluid2d.run_smoke_indirect(
            workdir, e2e_iterations=counts["e2e_iterations"], seed=seed,
            resume=resume, **kw)
    else:
        results = fluid2d.run_natural_flow_128(
            workdir, e2e_iterations=counts["e2e_iterations"], seed=seed,
            datadir=os.path.join(workdir, "data"), resume=resume, **kw)
    return results


def _compare_burgers(workdir: str, counts: dict, resume: bool,
                     kw: dict) -> dict:
    """`compare_schemes.compare_burgers` at `counts`; the adjoint row at
    `counts['adjoint_iterations']` (the entry's own 500 unless cut), and
    the launches of K1-K5 over the run in `launches`."""
    from pde_control_tpu_torch.experiments import compare_schemes
    from pde_control_tpu_torch.ops import launch_counts

    comparison = compare_schemes.run_comparison
    if counts["adjoint_iterations"] != 500:
        compare_schemes.run_comparison = (
            lambda *a, **k: comparison(
                *a, **k, adjoint_iterations=counts["adjoint_iterations"]))
    if not resume:  # a stale ckpt_ops would seed the OP stages
        shutil.rmtree(workdir, ignore_errors=True)
    before = launch_counts()
    try:
        results = compare_schemes.compare_burgers(workdir, resume=resume, **kw)
    finally:
        compare_schemes.run_comparison = comparison
    results["launches"] = _launch_delta(before)
    print(f"launches of K1-K5 over the run (Burgers runs none): "
          f"{results['launches']}", flush=True)
    return results


def run_cli(config: str, counts: dict, device: str, workdir: str) -> dict:
    entry = CONFIGS[config]["entry"]
    cmd = [sys.executable, "-m", "pde_control_tpu_torch.experiments.run",
           entry, "--iterations", str(counts["iterations"]), "--workdir",
           workdir, "--device", device]
    if not entry.startswith("burgers"):  # the Burgers entries fix theirs
        cmd += ["--num-train", str(counts["num_train"])]
        if counts["num_val"] != 32:
            cmd += ["--num-val", str(counts["num_val"])]
    if counts["e2e_iterations"]:
        cmd += ["--e2e-iterations", str(counts["e2e_iterations"])]
    print("running:", " ".join(cmd[1:]), flush=True)
    subprocess.run(cmd, cwd=ROOT, check=True, stdout=subprocess.DEVNULL)
    with open(os.path.join(workdir, "results.json")) as f:
        return json.load(f)


def cross_eval(config: str, counts: dict, device: str, workdir: str) -> dict:
    """The eval block of the run's final networks (`workdir/ckpt_final`)
    on the JAX package's validation set, generated here from its draws."""
    from pde_control_tpu_torch import ControlTraining
    from pde_control_tpu_torch.experiments import fluid2d
    from pde_control_tpu_torch.experiments.curriculum import (
        evaluate_control,
        op_spans,
    )

    # One training chunk: the setups generate a training set too.
    with patch_draws(CONFIGS[config]["draws"]):
        if config == "config4":
            pde, _, val = fluid2d._smoke_indirect_setup(
                64, 16, 8, counts["num_val"], 1.0, None, device=device)
        else:
            pde, _, val = fluid2d._shape_transition_setup(
                64, 16, 8, counts["num_val"], None, device=device)
    app = ControlTraining(
        16, pde, dataset=val, val_dataset=val, batch_size=8,
        trainable_networks=("CFE",) + tuple(f"OP{s}" for s in op_spans(16)),
        sequence_class="staggered", obs_loss_frames=(16,),
        restore=os.path.join(workdir, "ckpt_final")).prepare()
    ev = evaluate_control(app, val, 16)
    mse, zero = ev["final_state_mse"], ev["zero_force_final_mse"]
    print(f"the run's networks on the JAX package's validation set: controlled "
          f"{mse:.4e} ± {ev['final_state_mse_sem']:.2e} (sem), zero force "
          f"{zero:.6e}, ratio {zero / mse:.1f}x", flush=True)
    return dict(final_state_mse=mse, final_state_mse_sem=ev["final_state_mse_sem"],
                zero_force_final_mse=zero, ratio=zero / mse)


def jax_runs(config: str) -> list:
    """The JAX package's published results of `config`: its runs'
    `results.json`, or for config 1 the eval of `RESULTS.md`'s row."""
    def load(name):
        with open(os.path.join(RUNS, name, "results.json")) as f:
            return json.load(f)

    if config == "config1":
        zero = load("burgers_hierarchical")["eval"]["zero_force_final_mse"]
        return [{"eval": dict(CONFIG1_EVAL, zero_force_final_mse=zero)}]
    return [load(name) for name in CONFIGS[config]["refs"]]


def compare(config: str, draws: str, results: dict) -> dict:
    """Prints the port's stages and eval beside the JAX package's runs;
    returns the summary."""
    band, zero_rtol = CONFIGS[config]["band"], CONFIGS[config]["zero_rtol"]
    refs = jax_runs(config)
    stages = [s for s in STAGES if isinstance(results.get(s), dict)
              or any(s in r for r in refs)]
    print(f"{'stage':<18} {'port loss':>12} {'steps/s':>9} {'its':>6} "
          + " ".join(f"{'JAX run ' + str(i):>12}" for i in range(len(refs))))
    for stage in stages:
        got = results.get(stage, {})
        print(f"{stage:<18} {got.get('loss', float('nan')):>12.4e} "
              f"{got.get('steps_per_sec', float('nan')):>9.2f} "
              f"{got.get('iterations_run', '-')!s:>6} "
              + " ".join(f"{r.get(stage, {}).get('loss', float('nan')):>12.4e}"
                         for r in refs))
    ev = results["eval"]
    mse, zero = ev["final_state_mse"], ev["zero_force_final_mse"]
    jmse = [r["eval"]["final_state_mse"] for r in refs]
    jzero = refs[0]["eval"]["zero_force_final_mse"]
    jforce = [r["eval"].get("mean_abs_force") for r in refs]
    mean = float(np.mean(jmse))
    lo, hi = (1 - band) * mean, (1 + band) * mean
    summary = dict(
        config=config, draws=draws,
        final_state_mse=mse, final_state_mse_sem=ev["final_state_mse_sem"],
        zero_force_final_mse=zero, ratio=zero / mse,
        mean_abs_force=ev.get("mean_abs_force"),
        eval_samples=ev["eval_samples"],
        stage_loss={s: results.get(s, {}).get("loss") for s in stages},
        stage_steps_per_sec={s: results.get(s, {}).get("steps_per_sec")
                             for s in stages},
        stage_iterations_run={s: results.get(s, {}).get("iterations_run")
                              for s in stages},
        jax_final_state_mse=jmse,
        jax_final_state_mse_sem=[r["eval"].get("final_state_mse_sem")
                                 for r in refs],
        jax_zero_force_final_mse=jzero, jax_mean_abs_force=jforce,
        jax_ratio=[jzero / m for m in jmse],
        band=[lo, hi], controlled_in_band=bool(lo <= mse <= hi))
    print(f"eval: controlled final MSE {mse:.4e} ± {ev['final_state_mse_sem']:.2e} "
          f"(sem, {ev['eval_samples']} samples), zero force {zero:.6e}, "
          f"ratio {zero / mse:.1f}x, mean |F| {ev.get('mean_abs_force')}")
    print(f"JAX package: controlled {[f'{m:.4e}' for m in jmse]}, "
          f"zero force {jzero:.6e}, ratios "
          f"{[f'{jzero / m:.1f}x' for m in jmse]}, mean |F| {jforce}")
    print(f"controlled within ±{band:.0%} of the JAX runs' mean {mean:.4e} "
          f"[{lo:.3e}, {hi:.3e}]: {summary['controlled_in_band']}")
    if draws == "jax":
        rel = abs(zero - jzero) / jzero
        summary.update(zero_force_rel_err=rel,
                       zero_force_matches=bool(rel <= zero_rtol))
        print(f"zero force against the JAX package's: {rel:.3e} relative "
              f"(limit {zero_rtol:g}): {summary['zero_force_matches']}")
    return summary


def _rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def _band(got: float, centre: float, band: float) -> dict:
    """`got` against ±`band` around `centre`: the band, whether it holds
    `got`, and on which side `got` lies."""
    lo, hi = (1 - band) * centre, (1 + band) * centre
    return dict(band=[lo, hi], in_band=bool(lo <= got <= hi),
                side="inside" if lo <= got <= hi else (
                    "below" if got < lo else "above"))


def scheme_checks(results: dict, ref: dict) -> dict:
    """`compare_burgers`' checks (module docstring) on the port's
    `comparison.json` rows against the JAX package's `ref`: the verdicts
    and the figures they rest on."""
    spec = CONFIGS["compare_burgers"]
    zero = {s: (results[s]["zero_force_final_mse"],
                ref[s]["zero_force_final_mse"]) for s in SCHEMES}
    zero["zero_force"] = (results["zero_force"]["final_state_mse"],
                          ref["zero_force"]["final_state_mse"])
    zero_err = {k: _rel(a, b) for k, (a, b) in zero.items()}
    adj, jadj = (r["adjoint"]["final_state_mse"] for r in (results, ref))
    rows = {s: dict(final_state_mse=results[s]["final_state_mse"],
                    final_state_mse_sem=results[s].get("final_state_mse_sem"),
                    jax=ref[s]["final_state_mse"],
                    over_jax=results[s]["final_state_mse"]
                    / ref[s]["final_state_mse"],
                    **_band(results[s]["final_state_mse"],
                            ref[s]["final_state_mse"], spec["band"]))
            for s in SCHEMES}
    mse = {s: results[s]["final_state_mse"] for s in SCHEMES}
    jmse = {s: ref[s]["final_state_mse"] for s in SCHEMES}
    worst_by = mse["chain_final"] / max(mse["staggered"], mse["refined"])
    return dict(
        zero_force_rel_err=zero_err,
        zero_force_matches=all(e <= spec["zero_rtol"]
                               for e in zero_err.values()),
        adjoint_rel_err=_rel(adj, jadj),
        adjoint_matches=_rel(adj, jadj) <= ADJOINT_RTOL,
        rows=rows, schemes_in_band=all(r["in_band"] for r in rows.values()),
        chain_over_staggered=mse["chain_final"] / mse["staggered"],
        staggered_over_adjoint=mse["staggered"] / adj,
        jax_chain_over_staggered=jmse["chain_final"] / jmse["staggered"],
        jax_staggered_over_adjoint=jmse["staggered"] / jadj,
        chain_worst_by=worst_by, chain_worst=worst_by >= CHAIN_FACTOR,
        adjoint_below_schemes=adj < min(mse.values()))


def compare_schemes_table(results: dict, stages: dict) -> dict:
    """Prints `compare_burgers`' stages, rows and checks beside
    `comparison.json`'s; returns the summary."""
    with open(os.path.join(RUNS, "compare_burgers", "comparison.json")) as f:
        ref = json.load(f)
    nan = float("nan")
    print(f"{'stage':<18} {'final loss':>12} {'steps/s':>9} {'its':>6} "
          f"{'s':>8}")
    for tag, got in stages.items():
        print(f"{tag:<18} {got.get('loss', nan):>12.4e} "
              f"{got.get('steps_per_sec', nan):>9.2f} "
              f"{got.get('iterations_run', '-')!s:>6} {got['seconds']:>8.1f}")
    print(f"{'row':<12} {'port MSE':>11} {'± sem':>9} {'mean |F|':>9} "
          f"{'cost':>8} | {'JAX MSE':>11} {'± sem':>9} {'mean |F|':>9} "
          f"{'cost':>8}")

    def cells(row: dict) -> str:
        return (f"{row.get('final_state_mse', nan):>11.4e} "
                f"{row.get('final_state_mse_sem', nan):>9.2e} "
                f"{row.get('mean_abs_force', nan):>9.4f} "
                f"{row.get('mean_force_cost', nan):>8.4f}")

    for name in (*SCHEMES, "adjoint", "zero_force"):
        print(f"{name:<12} {cells(results[name])} | {cells(ref[name])}")
    c = scheme_checks(results, ref)
    zero_rtol = CONFIGS["compare_burgers"]["zero_rtol"]
    print("zero force against the JAX package's (the scheme rows' over "
          f"{results['chain_final']['eval_samples']} samples, the "
          "zero_force row's over the first 32): "
          + ", ".join(f"{k} {e:.3e}" for k, e in c["zero_force_rel_err"].items())
          + f" relative (limit {zero_rtol:g}): {c['zero_force_matches']}")
    print(f"adjoint {results['adjoint']['final_state_mse']:.4e} against "
          f"{ref['adjoint']['final_state_mse']:.4e}: {c['adjoint_rel_err']:.3e}"
          f" relative (limit {ADJOINT_RTOL:g}): {c['adjoint_matches']}; mean "
          f"|F| {results['adjoint']['mean_abs_force']:.4f} against "
          f"{ref['adjoint']['mean_abs_force']:.4f}")
    for s, r in c["rows"].items():
        print(f"{s}: {r['final_state_mse']:.4e} ± "
              f"{r['final_state_mse_sem']:.2e} (sem), {r['over_jax']:.3f}x the "
              f"JAX package's {r['jax']:.4e}; ±{CONFIGS['compare_burgers']['band']:.0%}"
              f" band [{r['band'][0]:.3e}, {r['band'][1]:.3e}]: {r['side']}")
    print(f"chain/staggered {c['chain_over_staggered']:.2f}x (JAX "
          f"{c['jax_chain_over_staggered']:.2f}x), staggered/adjoint "
          f"{c['staggered_over_adjoint']:.2f}x (JAX "
          f"{c['jax_staggered_over_adjoint']:.2f}x)")
    print(f"chain_final the worst scheme by >= {CHAIN_FACTOR:g}x: "
          f"{c['chain_worst']} ({c['chain_worst_by']:.2f}x); the adjoint below "
          f"every scheme: {c['adjoint_below_schemes']}", flush=True)
    rows = {k: {f: v for f, v in results[k].items() if not isinstance(v, list)}
            for k in (*SCHEMES, "adjoint", "zero_force")}
    return dict(config="compare_burgers", draws="jax", rows=rows, checks=c,
                stages={t: {k: v for k, v in got.items()
                            if k in ("loss", "steps_per_sec", "iterations_run",
                                     "seconds")}
                        for t, got in stages.items()},
                launches=results.get("launches"))


def ood_refs(config: str) -> list:
    """The JAX package's out-of-distribution runs of `config`."""
    out = []
    for name in OOD[config]["refs"]:
        with open(os.path.join(RUNS, name, "results.json")) as f:
            out.append(json.load(f))
    return out


def ood_checks(config: str, got: dict, refs: list, same_route: dict,
               train_eval: dict) -> dict:
    """`--ood`'s checks (module docstring) of the port's rows `got`
    against the JAX package's runs `refs`; `same_route` is the same nets'
    eval on the in-distribution set on the entry's route, `train_eval`
    the training run's own eval."""
    rows = {}
    for name, r in got.items():
        if not isinstance(r, dict):
            continue
        js = [ref[name] for ref in refs if name in ref]
        jmse = [j["final_state_mse"] for j in js]
        jzero = js[0]["zero_force_final_mse"]
        rows[name] = dict(
            final_state_mse=r["final_state_mse"],
            final_state_mse_sem=r["final_state_mse_sem"],
            zero_force_final_mse=r["zero_force_final_mse"],
            ratio=r["ratio_vs_zero_force"], mean_abs_force=r["mean_abs_force"],
            chain=name.endswith("_chain") or r.get("scheme") == "chain_final",
            jax_final_state_mse=jmse,
            jax_final_state_mse_sem=[j["final_state_mse_sem"] for j in js],
            jax_ratio=[j["ratio_vs_zero_force"] for j in js],
            jax_mean_abs_force=[j["mean_abs_force"] for j in js],
            jax_zero_force_final_mse=jzero,
            zero_force_rel_err=_rel(r["zero_force_final_mse"], jzero),
            **_band(r["final_state_mse"], float(np.mean(jmse)),
                    OOD_BANDS[min(len(js), 2)]))
    ind = got[OOD[config]["in_dist"]]
    gaps = {k: {"same_route": _rel(ind[k], same_route[k]),
                "training_eval": _rel(ind[k], train_eval[k])}
            for k in ("final_state_mse", "zero_force_final_mse")}
    ratio = {k: v["ratio"] for k, v in rows.items()}
    if config == "config3":
        findings = {"shapes > crosses > rings by ratio":
                    ratio["shapes"] > ratio["crosses"] > ratio["rings"]}
    else:
        a, b = ratio["obstacles_ood"], ratio["in_dist"]
        findings = {"obstacles_ood within 1.5x of in_dist's ratio":
                    max(a, b) / min(a, b) <= 1.5}
        if "inflow_shifted" in ratio:
            findings["inflow_shifted below 5x"] = ratio["inflow_shifted"] < 5
    return dict(
        rows=rows,
        zero_force_matches=all(r["zero_force_rel_err"] <= OOD_ZERO_RTOL
                               for r in rows.values()),
        in_dist_gaps=gaps,
        in_dist_equal=all(g["same_route"] <= OOD_IN_DIST_RTOL
                          for g in gaps.values()),
        controlled_in_band=all(r["in_band"] for r in rows.values()),
        findings=findings)


def run_ood(config: str, counts: dict, device: str, workdir: str,
            route: str, train_eval: dict) -> dict:
    """`--ood`: the port's out-of-distribution entry on `workdir`'s
    `ckpt_final` and the JAX package's draws of its sets, into
    `workdir/ood`; prints each row beside the JAX package's runs and the
    checks, and returns them."""
    from pde_control_tpu_torch.experiments import generalize
    from pde_control_tpu_torch.ops import launch_counts

    spec = OOD[config]
    # The same nets on the same validation set on the entry's own route:
    # the training run's eval, or on the kernel route one made here.
    same_route = (train_eval if route == "default"
                  else cross_eval(config, counts, device, workdir))
    before, t = launch_counts(), time.perf_counter()
    with patch_draws(spec["draws"]) as (pops, z):
        got = getattr(generalize, spec["entry"])(
            os.path.join(workdir, "ood"), os.path.join(workdir, "ckpt_final"),
            num_val=counts["num_val"], device=device)
    seconds, launches = time.perf_counter() - t, _launch_delta(before)
    print(f"{spec['entry']}: {seconds:.1f} s, launches {launches}; draws "
          f"popped from jax_draws_{spec['draws']}.npz: "
          f"{ {f'{s}/{k}': n for (s, k), n in sorted(pops.items())} }",
          flush=True)
    check_pops(pops, z, counts, spec["sets"])
    refs = ood_refs(config)
    c = ood_checks(config, got, refs, same_route, train_eval)
    nan = float("nan")
    print(f"{'row':<15} {'port MSE':>11} {'± sem':>9} {'zero force':>12} "
          f"{'ratio':>8} {'mean |F|':>10} | JAX runs "
          + ", ".join(spec["refs"]) + ": MSE ± sem, ratio, mean |F|")
    for name, r in c["rows"].items():
        jax = "; ".join(f"{m:.4e} ± {e:.2e}, {q:.2f}x, {f:.3e}" for m, e, q, f
                        in zip(r["jax_final_state_mse"],
                               r["jax_final_state_mse_sem"], r["jax_ratio"],
                               r["jax_mean_abs_force"]))
        print(f"{name:<15} {r['final_state_mse']:>11.4e} "
              f"{r['final_state_mse_sem']:>9.2e} "
              f"{r['zero_force_final_mse']:>12.6e} {r['ratio']:>8.2f} "
              f"{r.get('mean_abs_force', nan):>10.3e} | {jax}")
    for name, r in c["rows"].items():
        how = "by MSE and ratio (a chain_final row), " if r["chain"] else ""
        print(f"{name}: zero force {r['zero_force_rel_err']:.3e} relative to "
              f"{r['jax_zero_force_final_mse']:.6e} (limit {OOD_ZERO_RTOL:g}); "
              f"{how}controlled against ±{OOD_BANDS[min(len(r['jax_ratio']), 2)]:.0%}"
              f" [{r['band'][0]:.3e}, {r['band'][1]:.3e}]: {r['side']}")
    g = c["in_dist_gaps"]
    print(f"in-distribution row {spec['in_dist']} against the same nets' eval "
          f"on the same set and route: controlled "
          f"{g['final_state_mse']['same_route']:.3e}, zero force "
          f"{g['zero_force_final_mse']['same_route']:.3e} relative (limit "
          f"{OOD_IN_DIST_RTOL:g}): {c['in_dist_equal']}; against the training "
          f"run's own eval (route {route}): controlled "
          f"{g['final_state_mse']['training_eval']:.3e}, zero force "
          f"{g['zero_force_final_mse']['training_eval']:.3e} (the route gap; "
          f"{ROUTE_GAP_ZERO:g} on config 4's zero force at full counts)")
    print(f"every zero force within {OOD_ZERO_RTOL:g}: {c['zero_force_matches']}"
          f"; every controlled row in its band: {c['controlled_in_band']}; "
          + "; ".join(f"{k}: {v}" for k, v in c["findings"].items()),
          flush=True)
    return dict(c, seconds=seconds, launches=launches,
                same_route_eval=same_route, workdir=os.path.join(workdir, "ood"))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config", choices=sorted(CONFIGS))
    p.add_argument("--draws", choices=("jax", "port"), default="jax")
    p.add_argument("--device", default="cuda")
    p.add_argument("--cross-eval", action="store_true",
                   help="with --draws port (configs 3 and 4), also evaluate "
                        "the run's final networks on the JAX package's "
                        "validation set")
    for flag in ("iterations", "e2e_iterations", "num_train", "num_val",
                 "adjoint_iterations"):
        p.add_argument(f"--{flag.replace('_', '-')}", type=int, default=None)
    p.add_argument("--ood", action="store_true",
                   help="configs 3 and 4 with --draws jax: then evaluate "
                        "ckpt_final out of distribution (generalize_shapes, "
                        "generalize_smoke) on the JAX package's draws")
    p.add_argument("--seed", type=int, default=0,
                   help="the training seed of configs 3-5 with --draws jax "
                        "(the JAX package's runs: 0, 1 and 2)")
    p.add_argument("--save-to", default=None,
                   help="copy each checkpoint and autosave here as written")
    p.add_argument("--stop-after", default=None, choices=STAGES[1:-2],
                   help="end the call once this stage's checkpoint is written")
    p.add_argument("--resume-from", default=None,
                   help="an earlier call's --save-to directory")
    p.add_argument("--no-render", action="store_true",
                   help="leave out the log points' PNG renders")
    p.add_argument("--route", choices=("default", "kernel"), default="default",
                   help="kernel: train on K2-K5 (and on config 5 make the "
                        "data on K1), configs 4 and 5 with --draws jax")
    args = p.parse_args()
    if args.route == "kernel" and (args.config not in KERNEL_ROUTE
                                   or args.draws != "jax"):
        p.error("--route kernel takes config4 or config5 with --draws jax")
    if args.cross_eval and args.config not in ("config3", "config4"):
        p.error("--cross-eval takes config3 or config4")
    if args.ood and (args.config not in OOD or args.draws != "jax"):
        p.error("--ood takes config3 or config4 with --draws jax")
    if args.seed and (args.config not in ("config3", "config4", "config5")
                      or args.draws != "jax"):
        p.error("--seed takes config3, config4 or config5 with --draws jax")
    if args.config == "compare_burgers" and args.draws != "jax":
        p.error("compare_burgers runs on the JAX package's draws")
    split = (args.save_to, args.stop_after, args.resume_from, args.no_render)
    if any(split) and (args.draws != "jax" or args.config in (
            "config1", "config2", "compare_burgers")):
        p.error("--save-to, --stop-after, --resume-from and --no-render take "
                "config3, config4 or config5 with --draws jax")
    sys.path.insert(0, ROOT)
    counts = dict(CONFIGS[args.config]["counts"])
    if args.adjoint_iterations is not None and "adjoint_iterations" not in counts:
        p.error("--adjoint-iterations takes compare_burgers")
    for k in counts:
        if getattr(args, k) is not None:
            counts[k] = getattr(args, k)
    print(card_line(), flush=True)
    kernel = args.route == "kernel"
    print(f"{args.config}, draws {args.draws}, counts {counts}, device "
          f"{args.device}" + (", route kernel" if kernel else "")
          + (f", seed {args.seed}" if args.seed else ""), flush=True)
    workdir = os.path.join(ROOT, "runs", "quality_torch",
                           f"{args.config}_{args.draws}"
                           + ("_kernel" if kernel else "")
                           + (f"_s{args.seed}" if args.seed else ""))
    t0 = time.perf_counter()
    if args.draws == "jax":
        report_device_datasets(t0)
        stages = report_stages(t0)
        with (kernel_route(args.config, args.device) if kernel
              else contextlib.nullcontext()) as route, \
                split_run(workdir, args.save_to, args.stop_after,
                          args.resume_from, not args.no_render) as state:
            try:
                results = run_jax_draws(args.config, counts, args.device,
                                        workdir, resume=bool(args.resume_from),
                                        seed=args.seed)
            except StopAfterStage as e:
                print(f"stopped after {e} (--stop-after): "
                      f"{time.perf_counter() - t0:.1f} s; checkpoints, "
                      f"autosaves and records in {args.save_to}; go on with "
                      f"--resume-from {args.save_to}", flush=True)
                return
        results = merge_earlier(results, state["earlier"])
    else:
        results = run_cli(args.config, counts, args.device, workdir)
    wall = time.perf_counter() - t0
    if args.config == "compare_burgers":
        summary = compare_schemes_table(results, stages)
    else:
        summary = compare(args.config, args.draws, results)
    if kernel:
        compare_default_route(args.config, summary, results, route["data"])
    if args.ood:
        summary["ood"] = run_ood(args.config, counts, args.device, workdir,
                                 args.route, results["eval"])
    summary.update(wall_s=wall, counts=counts, seed=args.seed,
                   card=card_line())
    if args.draws == "jax":
        summary.update(digests=state["digests"],
                       resumed_from=args.resume_from,
                       stages_from_earlier_calls=sorted(
                           k for k, v in results.items()
                           if isinstance(v, dict) and v.get("from_earlier_call")))
    if args.cross_eval and args.draws == "port":
        summary["on_jax_val"] = cross_eval(args.config, counts, args.device,
                                           workdir)
    print(f"wall time {wall:.1f} s"
          + (f", then --ood {summary['ood']['seconds']:.1f} s" if args.ood
             else ""), flush=True)
    for where in (workdir, args.save_to):
        if where:
            with open(os.path.join(where, "summary.json"), "w") as f:
                json.dump(summary, f, indent=2)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
