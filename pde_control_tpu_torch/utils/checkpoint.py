"""Per-network parameter checkpoints, interchangeable with the JAX package.

Counterpart of `pde_control_tpu/utils/checkpoint.py`. Stages of a
curriculum communicate only through these files:
<dir>/<NAME>.msgpack holds one network's parameters in the layout of
`flax.serialization.to_bytes` (nested maps of flax names, arrays as
msgpack ext type 1; `utils/_msgpack.py`), and <dir>/manifest.json records
each file with a hash of its flax key paths and shapes. A checkpoint
written by either package loads in the other.

The functions here take and return the port's state dicts
({'CFE': {'Conv_0.weight': …}, 'OP16': …}); the conversion to flax names
and layouts is `utils/convert.py`'s.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Mapping

import numpy as np
import torch

from pde_control_tpu_torch.utils import _msgpack
from pde_control_tpu_torch.utils.convert import _flax_tree, _state_dict


def _leaves(tree: Mapping, path: tuple = ()):
    """(key path, leaf) pairs in sorted key order, as jax flattens a dict."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, Mapping):
            yield from _leaves(val, path + (key,))
        else:
            yield path + (key,), val


def _keystr(path: tuple) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _tree_hash(tree: Mapping) -> str:
    """The JAX package's `_tree_hash` of a flax tree: sha1 of the sorted
    'keypath:shape' strings, 12 hex digits."""
    parts = [f"{_keystr(path)}:{tuple(np.shape(leaf))}"
             for path, leaf in _leaves(tree)]
    return hashlib.sha1("|".join(sorted(parts)).encode()).hexdigest()[:12]


def save_networks(directory: str, params: Mapping[str, Mapping[str, torch.Tensor]],
                  metadata: dict | None = None) -> None:
    """Save each network's state dict ('CFE', 'OP2', …) to its own file.

    Partial saves merge: an existing manifest's entries for networks not
    being rewritten are kept (the curriculum saves one trained network at
    a time into a shared directory)."""
    os.makedirs(directory, exist_ok=True)
    manifest = {"networks": {}, "metadata": metadata or {}}
    manifest_path = os.path.join(directory, "manifest.json")
    if os.path.exists(manifest_path):
        try:
            with open(manifest_path) as f:
                prev = json.load(f)
            manifest["networks"] = {
                k: v for k, v in prev.get("networks", {}).items()
                if os.path.exists(os.path.join(directory, v.get("file", "")))}
        except (json.JSONDecodeError, OSError):
            pass
    for name, sd in params.items():
        tree = _flax_tree(sd)
        with open(os.path.join(directory, f"{name}.msgpack"), "wb") as f:
            f.write(_msgpack.packb(tree))
        manifest["networks"][name] = {"file": f"{name}.msgpack",
                                      "tree_hash": _tree_hash(tree)}
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2)


def _check_structure(path: str, got: Mapping, want: Mapping, at: tuple = ()):
    if set(got) != set(want):
        raise ValueError(
            f"checkpoint {path}: keys {sorted(got)} at {_keystr(at) or 'top'} "
            f"do not match the network's {sorted(want)}")
    for key, val in want.items():
        if isinstance(val, Mapping):
            if not isinstance(got[key], Mapping):
                raise ValueError(f"checkpoint {path}: {_keystr(at + (key,))} "
                                 "is an array where a subtree was expected")
            _check_structure(path, got[key], val, at + (key,))
        elif isinstance(got[key], Mapping):
            raise ValueError(f"checkpoint {path}: {_keystr(at + (key,))} "
                             "is a subtree where an array was expected")
        elif np.shape(got[key]) != np.shape(val):
            raise ValueError(
                f"checkpoint {path}: {_keystr(at + (key,))} has shape "
                f"{np.shape(got[key])}, the network {np.shape(val)}")


def load_network(path: str, target: Mapping[str, torch.Tensor] | None = None
                 ) -> dict[str, torch.Tensor]:
    """Load one network's state dict from a `.msgpack` file (CPU tensors).

    With `target` (a state dict of the network), the file's keys and
    shapes must match it. Raises on non-finite parameters: a stage that
    restored a diverged checkpoint would train on garbage."""
    with open(path, "rb") as f:
        tree = _msgpack.unpackb(f.read())
    if target is not None:
        _check_structure(path, tree, _flax_tree(target))
    for p, leaf in _leaves(tree):
        if not np.all(np.isfinite(leaf)):
            raise ValueError(
                f"checkpoint {path} has non-finite values at {_keystr(p)} — "
                "refusing to restore (the run that wrote it diverged; delete "
                "its workdir and retrain)")
    return _state_dict(tree)


def restore_networks(directory: str, params: Mapping[str, Mapping],
                     names: list[str] | None = None) -> dict:
    """Restore selected networks from a checkpoint dir into `params`."""
    out = dict(params)
    for name in names if names is not None else list(params):
        path = os.path.join(directory, f"{name}.msgpack")
        if os.path.exists(path):
            out[name] = load_network(path, params[name])
    return out


def _numpy_tree(tree: Mapping) -> dict:
    """Nested mapping of tensors or arrays → nested dict of numpy arrays."""
    return {k: _numpy_tree(v) if isinstance(v, Mapping)
            else v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in tree.items()}


def _tensor_tree(tree: Mapping) -> dict:
    return {k: _tensor_tree(v) if isinstance(v, Mapping)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def save_training_state(directory: str, params: Mapping, opt_state: Mapping,
                        step: int, extra: dict | None = None) -> None:
    """Full resume checkpoint: the networks (as save_networks writes them,
    under networks/), the optimizer's state and the step counter.

    `opt_state` is a nested mapping of tensors or arrays, written to
    opt_state.msgpack in the layout of `flax.serialization.to_bytes`, the
    JAX package's file. `ControlTraining` hands over optax's state tree
    (`ControlTraining._opt_state`), so that either package resumes an
    autosave the other wrote."""
    os.makedirs(directory, exist_ok=True)
    save_networks(os.path.join(directory, "networks"), params,
                  {"step": step, **(extra or {})})
    with open(os.path.join(directory, "opt_state.msgpack"), "wb") as f:
        f.write(_msgpack.packb(_numpy_tree(opt_state)))
    with open(os.path.join(directory, "state.json"), "w") as f:
        json.dump({"step": step, **(extra or {})}, f)


def load_training_state(directory: str, params: Mapping, opt_state: Mapping):
    """Restore (params, opt_state, step) saved by either package's
    save_training_state. `params`/`opt_state` are templates with the target
    structure; the optimizer state comes from opt_state.msgpack, the only
    file read for it, as a nested dict of CPU tensors. A file whose tree
    does not match the template (another trainable set, clip, schedule or
    shape) raises a ValueError naming it: nothing is restored in part."""
    params = restore_networks(os.path.join(directory, "networks"), params)
    path = os.path.join(directory, "opt_state.msgpack")
    with open(path, "rb") as f:
        tree = _msgpack.unpackb(f.read())
    try:
        _check_structure(path, tree, _numpy_tree(opt_state))
    except ValueError as e:
        raise ValueError(f"optimizer state in {path} does not match this app "
                         f"(another trainable set, clip or schedule?): {e}"
                         ) from None
    with open(os.path.join(directory, "state.json")) as f:
        step = json.load(f)["step"]
    return params, _tensor_tree(tree), step
