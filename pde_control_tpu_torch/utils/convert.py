"""Weight conversion from the JAX package's flax parameters.

`params_from_flax` takes the JAX package's parameter tree as nested dicts
of numpy arrays (`jax.device_get(app.params)`) and returns one state dict
per network, named as the port's modules name them. Names map one to one
(`ConvBlock_3/Conv_1/kernel` → `ConvBlock_3.Conv_1.weight`); conv kernels go
from flax's HWIO layout to torch's OIHW.
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
            if arr.ndim != 4:
                raise ValueError(f"{prefix}kernel: want a 2D conv kernel (HWIO), "
                                 f"got shape {arr.shape}")
            out[prefix + "weight"] = torch.from_numpy(
                np.array(arr.transpose(3, 2, 0, 1), order="C"))
        elif key == "bias":
            out[prefix + "bias"] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"unexpected flax parameter {prefix}{key}")
    return out


def params_from_flax(tree: Mapping) -> dict[str, dict[str, torch.Tensor]]:
    """{'CFE': flax params, 'OP16': …} → {'CFE': state dict, 'OP16': …}."""
    return {name: _state_dict(net) for name, net in tree.items()}
