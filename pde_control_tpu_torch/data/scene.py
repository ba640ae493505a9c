"""Scene-directory dataset I/O.

Counterpart of `pde_control_tpu/data/scene.py`, with the same on-disk
layout, so that a tree written by either package loads in the other:

    <root>/sim_000000/<field>_000000.{npy,npz}   (one array per field per frame)
    <root>/sim_000001/...
    <root>/manifest.json                         (load_or_generate's cache key)

plus range-based train/val splits. `TrajectoryDataset` holds stacked
trajectories in host memory (numpy); `DeviceDataset` keeps them on the
card and gathers batches there, drawing its indices on the host from the
caller's `np.random.Generator` exactly as the JAX package draws them, so
that the same seed gives the same batch order.

Frames are read with numpy; the JAX package's native C++ loader is not
ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from pde_control_tpu_torch.grids import resolve_device

_SCENE_FMT = "sim_{:06d}"
_FRAME_FMT = "{}_{:06d}.npz"
_FRAME_FMT_NPY = "{}_{:06d}.npy"


class Scene:
    """One simulation directory holding per-frame field arrays."""

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def create(cls, root: str, index: int) -> "Scene":
        path = os.path.join(root, _SCENE_FMT.format(index))
        os.makedirs(path, exist_ok=True)
        return cls(path)

    @classmethod
    def at(cls, root: str, index: int) -> "Scene":
        return cls(os.path.join(root, _SCENE_FMT.format(index)))

    def frame_path(self, name: str, frame: int, fmt: str = "npz") -> str:
        pattern = _FRAME_FMT if fmt == "npz" else _FRAME_FMT_NPY
        return os.path.join(self.path, pattern.format(name, frame))

    def write_frame(self, fields: dict[str, np.ndarray], frame: int,
                    fmt: str = "npz") -> None:
        """fmt='npz' (compressed) or 'npy' (raw float32)."""
        for name, arr in fields.items():
            if fmt == "npz":
                np.savez_compressed(self.frame_path(name, frame),
                                    data=np.asarray(arr))
            else:
                np.save(self.frame_path(name, frame, "npy"),
                        np.asarray(arr, np.float32))

    def read_frame(self, names: Sequence[str], frame: int) -> dict[str, np.ndarray]:
        out = {}
        for name in names:
            npz = self.frame_path(name, frame)
            if os.path.exists(npz):
                with np.load(npz) as z:
                    out[name] = z["data"]
            else:
                out[name] = np.load(self.frame_path(name, frame, "npy"))
        return out

    def frame_count(self, name: str) -> int:
        n = 0
        while (os.path.exists(self.frame_path(name, n))
               or os.path.exists(self.frame_path(name, n, "npy"))):
            n += 1
        return n


class TrajectoryDataset:
    """In-memory trajectories: obs (num, T, *spatial, C) [+ extra arrays].

    `sample(rng, batch_size)` returns a batch dict with 'obs' (B, T, …) plus
    any extras, sliced on the same indices.
    """

    def __init__(self, obs: np.ndarray, **extras: np.ndarray):
        self.obs = np.asarray(obs)
        self.extras = {k: np.asarray(v) for k, v in extras.items()}
        for k, v in self.extras.items():
            assert v.shape[0] == self.obs.shape[0], k

    def __len__(self) -> int:
        return self.obs.shape[0]

    def sample(self, rng: np.random.Generator, batch_size: int) -> dict:
        return self.take(rng.integers(0, len(self), size=batch_size))

    def take(self, idx: np.ndarray) -> dict:
        """Deterministic batch at explicit indices (full-set evaluation)."""
        idx = np.asarray(idx)
        batch = {"obs": self.obs[idx]}
        for k, v in self.extras.items():
            batch[k] = v[idx]
        return batch

    def slice(self, start: int, stop: int) -> "TrajectoryDataset":
        return TrajectoryDataset(
            self.obs[start:stop],
            **{k: v[start:stop] for k, v in self.extras.items()},
        )


def concat_datasets(*datasets: TrajectoryDataset) -> TrajectoryDataset:
    """Concatenate trajectory datasets along the sample axis. All inputs
    must carry the same extras keys and per-sample shapes."""
    keys = set(datasets[0].extras)
    for d in datasets[1:]:
        if set(d.extras) != keys:
            raise ValueError(
                f"extras mismatch: {sorted(keys)} vs {sorted(d.extras)}")
    return TrajectoryDataset(
        np.concatenate([d.obs for d in datasets]),
        **{k: np.concatenate([d.extras[k] for d in datasets])
           for k in keys})


class DeviceDataset:
    """Device-resident trajectory store: the arrays are copied to the
    device once and each `sample` is a gather there, so the training loop
    moves only a B-int index vector to the device. Same `sample(rng, B)`
    contract, and the same draws for a given rng, as TrajectoryDataset.

    A store larger than the budget (half the card's free memory when it is
    wrapped) is kept in float16 and cast back to float32 in the gather; one
    larger than twice the budget stays on the host (TrajectoryDataset). On
    the CPU the store is the host arrays themselves, with no budget.
    """

    def __init__(self, obs, store_dtype=None, device=None, **extras):
        self.device = resolve_device(device)

        def put(a):
            a = np.asarray(a)
            if store_dtype is not None and a.dtype == np.float32:
                a = a.astype(store_dtype)
            return torch.as_tensor(a, device=self.device)

        self.obs = put(obs)
        self.extras = {k: put(v) for k, v in extras.items()}
        self._arrays = {"obs": self.obs, **self.extras}

    @staticmethod
    def budget_bytes(device: torch.device) -> int | None:
        """Bytes a device-resident store may take: half the card's free
        memory, or None (no limit) on the CPU."""
        if device.type != "cuda":
            return None
        return torch.cuda.mem_get_info(device)[0] // 2

    @classmethod
    def wrap(cls, ds, device=None):
        """DeviceDataset view of a TrajectoryDataset on `device` (or the
        dataset itself if it already is a DeviceDataset, is not a
        TrajectoryDataset, or is too big to keep on the device).

        The view is cached on the source dataset, one per device: a
        curriculum builds several apps from the same dataset and each
        prepare() wraps it. The view holds only the data tensors, so the
        cache keeps no app alive."""
        if isinstance(ds, cls) or not isinstance(ds, TrajectoryDataset):
            return ds
        device = resolve_device(device)
        views = ds.__dict__.setdefault("_device_views", {})
        if str(device) in views:
            return views[str(device)]
        total = ds.obs.nbytes + sum(v.nbytes for v in ds.extras.values())
        budget = cls.budget_bytes(device)
        store_dtype = None
        if budget is not None and total > budget:
            if total // 2 > budget:
                return ds  # too big even at fp16: host feeding
            store_dtype = np.float16
        view = cls(ds.obs, store_dtype=store_dtype, device=device, **ds.extras)
        views[str(device)] = view
        return view

    def __len__(self) -> int:
        return int(self.obs.shape[0])

    def _gather(self, idx) -> dict[str, torch.Tensor]:
        i = torch.as_tensor(np.asarray(idx, np.int64)).to(self.device,
                                                          non_blocking=True)
        out = {}
        for k, v in self._arrays.items():
            g = torch.index_select(v, 0, i)
            # fp16-stored arrays come back fp32 (the training dtype).
            out[k] = g.float() if g.dtype == torch.float16 else g
        return out

    def sample(self, rng: np.random.Generator, batch_size: int) -> dict:
        return self._gather(rng.integers(0, len(self), size=batch_size))

    def take(self, idx: np.ndarray) -> dict:
        """Deterministic batch at explicit indices (full-set evaluation)."""
        return self._gather(idx)

    def sample_stacked(self, rng: np.random.Generator, k: int,
                       batch_size: int) -> dict:
        """k stacked batches (leading (k, B) axes) in one gather, for
        ControlTraining.progress_multi."""
        flat = self._gather(rng.integers(0, len(self), size=k * batch_size))
        return {name: v.reshape((k, batch_size) + tuple(v.shape[1:]))
                for name, v in flat.items()}


class SceneDataset:
    """Range-based reader over a scene root."""

    def __init__(self, root: str, field: str = "obs",
                 sim_range: range | None = None):
        self.root = root
        self.field = field
        if sim_range is None:
            count = 0
            while os.path.isdir(os.path.join(root, _SCENE_FMT.format(count))):
                count += 1
            sim_range = range(count)
        self.sim_range = sim_range

    def load_trajectories(self, frames: int | None = None) -> TrajectoryDataset:
        """Load all scenes into memory (numpy, .npy or .npz frames)."""
        sims = list(self.sim_range)
        first = Scene.at(self.root, sims[0])
        t = first.frame_count(self.field) if frames is None else frames
        trajs = []
        for i in sims:
            scene = Scene.at(self.root, i)
            trajs.append(np.stack(
                [scene.read_frame([self.field], f)[self.field]
                 for f in range(t)]))
        return TrajectoryDataset(np.stack(trajs))

    def write_trajectories(self, obs: np.ndarray, fmt: str = "npz") -> None:
        """obs: (num, T, *spatial, C) — write each trajectory as a scene."""
        if len(obs) > len(self.sim_range):
            raise ValueError(
                f"{len(obs)} trajectories exceed sim_range "
                f"({len(self.sim_range)} scenes)")
        for i, traj in enumerate(obs):
            scene = Scene.create(self.root, self.sim_range[i])
            for f, frame in enumerate(traj):
                scene.write_frame({self.field: frame}, f, fmt=fmt)


def save_dataset(root: str, ds: TrajectoryDataset, fmt: str = "npy") -> None:
    """Write a TrajectoryDataset as a scene tree: per-frame obs arrays to
    sim_######/obs_######.{npy,npz}, per-trajectory extras (vy0/vx0/inflow)
    as frame 0 of their own field name."""
    for i in range(len(ds)):
        scene = Scene.create(root, i)
        for f in range(ds.obs.shape[1]):
            scene.write_frame({"obs": ds.obs[i, f]}, f, fmt=fmt)
        for name, arr in ds.extras.items():
            scene.write_frame({name: arr[i]}, 0, fmt=fmt)


def load_dataset(root: str, num: int, frames: int,
                 extras: Sequence[str] = ()) -> TrajectoryDataset:
    """Load a save_dataset tree back into memory."""
    ds = SceneDataset(root, sim_range=range(num)).load_trajectories(
        frames=frames)
    ex = {name: np.stack([Scene.at(root, i).read_frame([name], 0)[name]
                          for i in range(num)])
          for name in extras}
    return TrajectoryDataset(ds.obs, **ex)


def load_or_generate(root: str, params: dict, build,
                     fmt: str = "npy") -> TrajectoryDataset:
    """Disk-cached dataset: generate once to a scene tree, reload thereafter.

    `params` (generation parameters, JSON-serializable) are stored in
    <root>/manifest.json; any change regenerates. `build` is the
    () -> TrajectoryDataset generator to run on a cache miss.
    """
    key = json.dumps(params, sort_keys=True, default=str)
    manifest_path = os.path.join(root, "manifest.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
        if manifest.get("params_key") == key:
            return load_dataset(root, manifest["num"], manifest["frames"],
                                extras=manifest["extras"])
    ds = build()
    os.makedirs(root, exist_ok=True)
    save_dataset(root, ds, fmt=fmt)
    with open(manifest_path, "w") as f:
        json.dump({"params_key": key, "num": len(ds),
                   "frames": int(ds.obs.shape[1]),
                   "extras": sorted(ds.extras), "fmt": fmt}, f, indent=2)
    return ds
