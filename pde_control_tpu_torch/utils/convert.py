"""Weight conversion between the port's state dicts and flax parameters.

`params_from_flax` takes the JAX package's parameter tree as nested dicts
of numpy arrays (`jax.device_get(app.params)`) and returns one state dict
per network, named as the port's modules name them. Names map one to one
(`ConvBlock_3/Conv_1/kernel` → `ConvBlock_3.Conv_1.weight`); conv kernels go
from flax's spatial-first layout to torch's: HWIO → OIHW in 2D, WIO → OIW
in 1D, DHWIO → OIDHW in 3D. `params_to_flax` is its inverse and
round-trips exactly.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _state_dict(tree: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_state_dict(val, f"{prefix}{key}."))
            continue
        arr = np.asarray(val, dtype=np.float32)
        if key == "kernel":
            if arr.ndim not in (3, 4, 5):
                raise ValueError(f"{prefix}kernel: want a 1D, 2D or 3D conv "
                                 f"kernel (WIO, HWIO or DHWIO), got shape "
                                 f"{arr.shape}")
            sp = tuple(range(arr.ndim - 2))
            out[prefix + "weight"] = torch.from_numpy(np.array(
                arr.transpose(arr.ndim - 1, arr.ndim - 2, *sp), order="C"))
        elif key == "bias":
            out[prefix + "bias"] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"unexpected flax parameter {prefix}{key}")
    return out


def params_from_flax(tree: Mapping) -> dict[str, dict[str, torch.Tensor]]:
    """{'CFE': flax params, 'OP16': …} → {'CFE': state dict, 'OP16': …}."""
    return {name: _state_dict(net) for name, net in tree.items()}


def _flax_tree(sd: Mapping[str, torch.Tensor]) -> dict:
    out: dict = {}
    for key, val in sd.items():
        *path, leaf = key.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        arr = val.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            if arr.ndim not in (3, 4, 5):
                raise ValueError(f"{key}: want a 1D, 2D or 3D conv weight "
                                 f"(OIW, OIHW or OIDHW), got shape "
                                 f"{arr.shape}")
            node["kernel"] = np.array(
                arr.transpose(*range(2, arr.ndim), 1, 0), order="C")
        elif leaf == "bias":
            node["bias"] = arr.copy()
        else:
            raise KeyError(f"unexpected parameter {key}")
    return out


def params_to_flax(params: Mapping[str, Mapping[str, torch.Tensor]]) -> dict:
    """{'CFE': state dict, 'OP16': …} → {'CFE': flax params, …}: nested
    dicts of float32 numpy arrays, kernels in WIO, HWIO or DHWIO."""
    return {name: _flax_tree(sd) for name, sd in params.items()}
