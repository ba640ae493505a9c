"""The port's checkpoints, msgpack codec and utilities against the JAX
package's, on the CPU.

Held to (exact, bit for bit, unless said):
* `params_to_flax` inverts `params_from_flax`;
* the codec's bytes for a parameter tree equal
  `flax.serialization.to_bytes` of the tree as `jax.device_get` leaves it
  (sorted keys), and its decoder reads flax's bytes back;
* the JAX package's `save_networks` → the port's `restore_networks`, and
  the port's `save_networks` → the JAX package's `load_network`, give
  identical arrays; `manifest.json`'s `tree_hash` is the JAX package's;
* a checkpoint holding a NaN is refused, as is one of another shape;
* `save_training_state` / `load_training_state` round-trip the networks,
  the optimizer state and the step;
* the PNG writer, the metrics logger and the dataset epoch.
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from pde_control_tpu.utils import checkpoint as jckpt
from pde_control_tpu.utils import epoch as jepoch
from pde_control_tpu_torch import Domain2D, IncompressibleFluidPDE
from pde_control_tpu_torch.utils import _msgpack, checkpoint, epoch, viz
from pde_control_tpu_torch.utils.convert import params_from_flax, params_to_flax
from pde_control_tpu_torch.utils.logging import MetricsLogger

torch.set_num_threads(1)

_JAX = {}


def _jax_params():
    """A parameter tree in the JAX package's layout, as `jax.device_get`
    returns it (sorted keys, float32 numpy, kernels HWIO): a CFE with six
    input channels and two 2-level U-nets, built by the port at 16² and
    filled from a numpy seed (cached)."""
    if "params" not in _JAX:
        pde = IncompressibleFluidPDE(
            Domain2D.create(16, 16, device="cpu"), control="buoyancy",
            with_inflow=True, unet_levels=2, cfe_features=(8, 16),
            op_base_features=4, dtype=torch.float32)
        rng = np.random.default_rng(0)
        sds = {name: {k: torch.from_numpy(
                   rng.normal(size=tuple(v.shape)).astype(np.float32))
                   for k, v in net.state_dict().items()}
               for name, net in (("CFE", pde.build_cfe()),
                                 ("OP4", pde.build_op()),
                                 ("OP2", pde.build_op()))}
        _JAX["params"] = jax.device_get(jax.tree_util.tree_map(
            jnp.asarray, params_to_flax(sds)))
    return _JAX["params"]


def test_params_to_flax_inverts_params_from_flax():
    params = _jax_params()
    back = params_to_flax(params_from_flax(params))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("net", ["CFE", "OP4"])
def test_codec_bytes_equal_flax_to_bytes(net):
    tree = _jax_params()[net]
    assert _msgpack.packb(tree) == flax.serialization.to_bytes(tree)
    back = _msgpack.unpackb(flax.serialization.to_bytes(tree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -129, -2**31 - 1,
    "", "x" * 31, "y" * 32, "z" * 300, b"\x00" * 300, None, True, False, 1.5,
    [1, [2, 3]], list(range(20)), {"b": 1, "a": {"c": "d"}},
    {f"k{i:02d}": i for i in range(20)},
    np.arange(6, dtype=np.float32).reshape(2, 3), np.zeros(0, np.int32),
    np.ones((70, 70), np.float16), np.float32(2.5), np.int64(-3),
])
def test_codec_matches_msgpack_and_round_trips(value):
    """Each msgpack form the codec writes, against the msgpack package's
    bytes as flax packs them, and back."""
    want = flax.serialization.msgpack_serialize(value) \
        if isinstance(value, (dict, np.ndarray, np.generic)) else None
    got = _msgpack.packb(value)
    if want is not None and isinstance(value, dict):
        # flax keeps insertion order; the codec sorts.
        want = flax.serialization.msgpack_serialize(
            {k: value[k] for k in sorted(value)})
    if want is not None:
        assert got == want
    else:
        import msgpack
        assert got == msgpack.packb(value, use_bin_type=True)
    back = _msgpack.unpackb(got)
    if isinstance(value, np.ndarray):
        np.testing.assert_array_equal(back, value)
        assert back.dtype == value.dtype
    elif isinstance(value, np.generic):
        assert back == value and back.dtype == value.dtype
    else:
        assert back == value


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    params = _jax_params()
    jckpt.save_networks(str(tmp_path), params, {"n": 4})
    templates = {k: {kk: torch.zeros_like(v) for kk, v in sd.items()}
                 for k, sd in params_from_flax(params).items()}
    got = checkpoint.restore_networks(str(tmp_path), templates)
    want = params_from_flax(params)
    assert set(got) == set(want)
    for net in want:
        assert set(got[net]) == set(want[net])
        for k, v in want[net].items():
            assert torch.equal(got[net][k], v), f"{net}.{k}"


def test_port_checkpoint_loads_in_jax(tmp_path):
    params = _jax_params()
    sds = params_from_flax(params)
    checkpoint.save_networks(str(tmp_path), sds, {"n": 4})
    for net, tree in params.items():
        got = jckpt.load_network(str(tmp_path / f"{net}.msgpack"), tree)
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(np.asarray(a), b)
    mine = json.loads((tmp_path / "manifest.json").read_text())
    jckpt.save_networks(str(tmp_path / "jax"), params, {"n": 4})
    theirs = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    assert mine == theirs
    assert {v["tree_hash"] for v in mine["networks"].values()} == {
        jckpt._tree_hash(t) for t in params.values()}


def test_partial_saves_merge(tmp_path):
    sds = params_from_flax(_jax_params())
    checkpoint.save_networks(str(tmp_path), {"OP2": sds["OP2"]})
    checkpoint.save_networks(str(tmp_path), {"OP4": sds["OP4"]})
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert set(manifest["networks"]) == {"OP2", "OP4"}


def test_nonfinite_or_misshapen_checkpoint_is_refused(tmp_path):
    sds = params_from_flax(_jax_params())
    bad = {k: v.clone() for k, v in sds["CFE"].items()}
    bad["Conv_0.bias"][1] = float("nan")
    checkpoint.save_networks(str(tmp_path), {"CFE": bad})
    with pytest.raises(ValueError, match="non-finite"):
        checkpoint.load_network(str(tmp_path / "CFE.msgpack"), sds["CFE"])
    with pytest.raises(ValueError, match="non-finite"):
        jckpt.load_network(str(tmp_path / "CFE.msgpack"),
                           _jax_params()["CFE"])
    checkpoint.save_networks(str(tmp_path), {"CFE": sds["OP4"]})
    with pytest.raises(ValueError, match="keys"):
        checkpoint.load_network(str(tmp_path / "CFE.msgpack"), sds["CFE"])


def test_training_state_round_trips(tmp_path):
    sds = params_from_flax(_jax_params())
    opt = {"mu": torch.randn(5), "nu": torch.rand(5),
           "count": torch.tensor(3, dtype=torch.int32)}
    checkpoint.save_training_state(str(tmp_path), sds, opt, 7,
                                   {"sequence_class": "chain"})
    zeros = {k: {kk: torch.zeros_like(v) for kk, v in sd.items()}
             for k, sd in sds.items()}
    params, got, step = checkpoint.load_training_state(
        str(tmp_path), zeros, {k: torch.zeros_like(v) for k, v in opt.items()})
    assert step == 7
    for k in opt:
        assert torch.equal(got[k], opt[k])
    for net in sds:
        for k in sds[net]:
            assert torch.equal(params[net][k], sds[net][k])
    with pytest.raises(ValueError, match="optimizer state"):
        checkpoint.load_training_state(str(tmp_path), zeros,
                                       {"mu": torch.zeros(4)})


# ----------------------------------------------------------------- utilities

def _read_png(path):
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xffffffff
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h = struct.unpack(">II", chunks[b"IHDR"][:8])
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_panels_side_by_side(tmp_path):
    field = np.zeros((16, 16), np.float32)
    field[0, 0] = 1.0  # row 0 is drawn at the bottom
    path = str(tmp_path / "a" / "cmp.png")
    viz.save_comparison_png({"a": field, "b": -field}, path)
    img = _read_png(path)
    assert img.shape == (128, 2 * 128 + 4, 3)
    assert tuple(img[-1, 0]) == (253, 231, 37)    # the maximum, viridis top
    assert tuple(img[-1, 132]) == (68, 1, 84)     # the minimum, viridis bottom
    viz.save_field_png(np.linspace(0, 1, 50), str(tmp_path / "curve.png"))
    assert _read_png(str(tmp_path / "curve.png")).shape[1] == 50
    viz.save_trajectory_strip(np.stack([field] * 3), str(tmp_path / "s.png"))
    assert _read_png(str(tmp_path / "s.png")).shape[1] == 3 * 128 + 8


def test_metrics_logger_writes_jsonl(tmp_path):
    log = MetricsLogger(str(tmp_path), use_tensorboard=False)
    log.log(3, {"loss": torch.tensor(0.5), "n": 2}, prefix="train/")
    log.close()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["train/loss"] == 0.5 and rec["train/n"] == 2.0
    MetricsLogger(None).log(1, {"x": 1.0})  # no logdir: a no-op


def test_epoch_is_the_jax_packages(tmp_path):
    path = str(tmp_path / ".vm_epoch")
    token = epoch.vm_epoch(path)
    assert jepoch.vm_epoch(path) == token and len(token) == 12
    assert epoch._EPOCH_FILE == jepoch._EPOCH_FILE
    assert epoch.stamp({"vm_epoch": "x"}) == {"vm_epoch": "x"}
