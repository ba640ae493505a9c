"""The native C++ frame gather (`data/native_loader.py`) and the scene trees
that read through it, on the CPU.

* The gathered frames are bit-equal to `np.stack` of `np.load` (float32,
  and float64 frames cast as numpy casts them).
* A tree written by the JAX package's `save_dataset` (.npy, with extras)
  loads to the same bits through the port's `load_dataset` as through the
  JAX package's; an .npz tree keeps numpy.
* The library is built from the port's own copy of the source into
  `pde_control_tpu_torch/_build/`; a missing or malformed file raises,
  naming it.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from pde_control_tpu.data import scene as jscene
from pde_control_tpu_torch.data import native_loader, scene

PKG = Path(native_loader.__file__).resolve().parent.parent


def _write(tmp_path, frames):
    paths = []
    for i, fr in enumerate(frames):
        p = str(tmp_path / f"f{i}.npy")
        np.save(p, fr)
        paths.append(p)
    return paths


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gather_is_bit_equal_to_numpy(tmp_path, rng, dtype):
    frames = [rng.normal(size=(7, 9, 1)).astype(dtype) for _ in range(13)]
    paths = _write(tmp_path, frames)
    out = native_loader.gather_frames(paths, (7, 9, 1), n_threads=4)
    want = np.stack([np.load(p) for p in paths]).astype(np.float32)
    assert out.dtype == np.float32 and out.shape == want.shape
    assert out.tobytes() == want.tobytes()


def test_library_builds_into_the_port(tmp_path, rng):
    native_loader.gather_frames(_write(tmp_path, [np.zeros(3, np.float32)]),
                                (3,))
    lib = native_loader.library_path()
    assert lib.parent == PKG / "_build" and lib.exists()
    assert native_loader.SRC == PKG / "data" / "csrc" / "scene_loader.cpp"


def test_bad_files_raise(tmp_path, rng):
    good = _write(tmp_path, [rng.normal(size=(4, 4)).astype(np.float32)])[0]
    with pytest.raises(OSError, match="missing.npy: cannot open"):
        native_loader.gather_frames([good, str(tmp_path / "missing.npy")],
                                    (4, 4))
    with pytest.raises(OSError, match="element count"):
        native_loader.gather_frames([good], (4, 5))
    ints = str(tmp_path / "ints.npy")
    np.save(ints, np.zeros((4, 4), np.int32))
    with pytest.raises(OSError, match="unsupported dtype"):
        native_loader.gather_frames([ints], (4, 4))


@pytest.mark.parametrize("fmt", ["npy", "npz"])
def test_jax_written_tree_loads_to_the_same_bits(tmp_path, rng, fmt):
    obs = rng.normal(size=(5, 4, 8, 8, 1)).astype(np.float32)
    extras = dict(vy0=rng.normal(size=(5, 9, 8)).astype(np.float32),
                  inflow=rng.uniform(size=(5, 8, 8)).astype(np.float32))
    root = str(tmp_path / "tree")
    jscene.save_dataset(root, jscene.TrajectoryDataset(obs, **extras), fmt=fmt)
    got = scene.load_dataset(root, 5, 4, extras=("vy0", "inflow"))
    want = jscene.load_dataset(root, 5, 4, extras=("vy0", "inflow"))
    assert got.obs.tobytes() == want.obs.tobytes() == obs.tobytes()
    for k, v in extras.items():
        assert got.extras[k].dtype == np.float32
        assert got.extras[k].tobytes() == want.extras[k].tobytes() == v.tobytes()
    assert os.path.exists(os.path.join(root, "sim_000000",
                                       f"obs_000000.{fmt}"))


def test_scene_dataset_reads_npy_through_the_gather(tmp_path, rng, monkeypatch):
    obs = rng.normal(size=(3, 4, 8, 8, 1)).astype(np.float32)
    ds = scene.SceneDataset(str(tmp_path / "s"), sim_range=range(3))
    ds.write_trajectories(obs, fmt="npy")
    calls = []
    real = scene.gather_frames
    monkeypatch.setattr(scene, "gather_frames",
                        lambda paths, shape: calls.append(len(paths))
                        or real(paths, shape))
    assert ds.load_trajectories().obs.tobytes() == obs.tobytes()
    assert calls == [12]
