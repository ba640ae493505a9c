"""A mid-stage autosave crosses between the packages, on the CPU.

Both packages keep the optimizer of an autosave (`ControlTraining.autosave`,
`autosave_<tag>` under a curriculum's workdir) in opt_state.msgpack: the
state tree of the JAX package's `apply_if_finite(multi_transform({'train':
chain(clip_by_global_norm, adam(cosine)), 'freeze': set_to_zero()}))` in
flax's `to_bytes` layout. At 8², n=4, direct control, fp32 nets (CFE 4-4,
U-nets of 2 levels, base width 2), the staggered class with CFE and OP4
trainable and OP2 frozen, clip 1.0, a cosine schedule, pressure tol 1e-6:
* an autosave the JAX package wrote after two steps and a skipped
  non-finite one restores in the port to the JAX package's optimizer tree
  bit for bit (moments, both counts, the non-finite counters), and two
  more steps give the JAX package's parameters within atol 1e-6 (the
  tolerance of the Adam steps in `tests/test_torch_control.py`);
* an autosave the port wrote restores in the JAX package, and two more
  steps there give the port's parameters within atol 1e-6;
* an autosave of another trainable set, clip or schedule raises a
  ValueError naming the file;
* the port's tree has the JAX package's keys, shapes and dtypes for each
  combination of clip, schedule and non-finite skip.
"""

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from pde_control_tpu.control.pde_fluid import IncompressibleFluidPDE as JPDE
from pde_control_tpu.control.training import ControlTraining as JApp
from pde_control_tpu.grids import Domain2D as JDomain
from pde_control_tpu.physics.fluid import FluidConfig as JConfig
from pde_control_tpu_torch import (
    ControlTraining,
    Domain2D,
    FluidConfig,
    IncompressibleFluidPDE,
    params_from_flax,
)
from pde_control_tpu_torch.utils.checkpoint import _leaves

torch.set_num_threads(1)

H, N, B = 8, 4, 2
_CFG = dict(dt=1.0, buoyancy=0.0, pressure_tol=1e-6, pressure_maxiter=300,
            warm_start_pressure=True)
_PDE = dict(control="direct", unet_levels=2, cfe_features=(4, 4),
            op_base_features=2)
_APP = dict(batch_size=B, trainable_networks=("CFE", "OP4"),
            sequence_class="staggered", grad_clip=1.0, lr_schedule="cosine",
            decay_steps=6, learning_rate=1e-2, seed=2)


def _jpde():
    return JPDE(JDomain.create(H, H), JConfig(**_CFG), dtype=jnp.float32,
                **_PDE)


def _tpde():
    return IncompressibleFluidPDE(Domain2D.create(H, H, device="cpu"),
                                  FluidConfig(**_CFG), dtype=torch.float32,
                                  **_PDE)


def _batch(seed, nan=False):
    rng = np.random.default_rng(seed)
    obs = rng.uniform(0, 1, size=(B, N + 1, H, H, 1)).astype(np.float32)
    if nan:
        obs[0, N, 3, 3, 0] = np.nan
    return {"obs": obs,
            "vy0": (0.1 * rng.normal(size=(B, H + 1, H))).astype(np.float32),
            "vx0": (0.1 * rng.normal(size=(B, H, H + 1))).astype(np.float32)}


# Two steps, a non-finite batch (skipped), the autosave, two more steps.
BEFORE = [_batch(0), _batch(1), _batch(2, nan=True)]
AFTER = [_batch(3), _batch(4)]


def _start_params():
    """Seeded weights with a nonzero CFE output layer, so that OP4 gets a
    gradient (cached)."""
    if "start" not in _CACHE:
        app = JApp(N, _jpde(), **_APP).prepare()
        params = jax.tree_util.tree_map(np.array, jax.device_get(app.params))
        k = params["CFE"]["Conv_2"]["kernel"]
        params["CFE"]["Conv_2"]["kernel"] = (0.05 * np.random.default_rng(5)
                                             .normal(size=k.shape)
                                             ).astype(np.float32)
        _CACHE["start"] = params
    return _CACHE["start"]


_CACHE = {}


def _japp(**kw):
    app = JApp(N, _jpde(), **dict(_APP, **kw)).prepare()
    app.params = jax.tree_util.tree_map(jnp.asarray, _start_params())
    return app


def _tapp(**kw):
    app = ControlTraining(N, _tpde(), **dict(_APP, **kw)).prepare()
    app.load_params(params_from_flax(_start_params()))
    return app


def _jax_tree(app) -> dict:
    return flax.serialization.to_state_dict(jax.device_get(app.opt_state))


def _assert_trees_equal(got: dict, want: dict, exact: bool = True):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w)
    for path in w:
        a, b = np.asarray(g[path]), np.asarray(w[path])
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=str(path))


def _assert_params_close(tapp, jparams, atol):
    want = params_from_flax(jax.device_get(jparams))
    for net, sd in tapp.state_dicts().items():
        for k, v in sd.items():
            np.testing.assert_allclose(v.numpy(), want[net][k].numpy(),
                                       rtol=0, atol=atol,
                                       err_msg=f"{net}.{k}")


def _jax_autosave(tmp_path):
    """The JAX package's autosave after BEFORE, its optimizer tree there,
    and its parameters after AFTER (cached per session directory)."""
    if "jax" not in _CACHE:
        japp = _japp()
        for b in BEFORE:
            japp.progress(b)
        path = str(tmp_path / "autosave_jax")
        japp.autosave(path)
        tree = _jax_tree(japp)
        for b in AFTER:
            japp.progress(b)
        _CACHE["jax"] = (path, tree, japp.params)
    return _CACHE["jax"]


def test_jax_autosave_resumes_in_the_port(tmp_path):
    path, tree, jparams = _jax_autosave(tmp_path)
    assert int(tree["total_notfinite"]) == int(tree["notfinite_count"]) == 1
    tapp = _tapp()
    assert tapp.try_restore_autosave(path) == len(BEFORE)
    _assert_trees_equal(tapp._opt_state(), tree)
    assert int(tapp.optimizer.count) == 2 and int(tapp.notfinite_consec) == 1
    for b in AFTER:
        tapp.progress(b)
    assert int(tapp.optimizer.count) == 4 and int(tapp.notfinite_consec) == 0
    _assert_params_close(tapp, jparams, atol=1e-6)


def test_port_autosave_resumes_in_the_jax_package(tmp_path):
    tapp = _tapp()
    for b in BEFORE:
        tapp.progress(b)
    path = str(tmp_path / "autosave_port")
    tapp.autosave(path)
    for b in AFTER:
        tapp.progress(b)
    japp = _japp()
    assert japp.try_restore_autosave(path) == len(BEFORE)
    for b in AFTER:
        japp.progress(b)
    assert int(japp.opt_state.total_notfinite) == 1
    _assert_params_close(tapp, japp.params, atol=1e-6)


@pytest.mark.parametrize("change", [
    dict(trainable_networks=("CFE", "OP2")),
    dict(grad_clip=None),
    dict(lr_schedule=None),
    dict(skip_nonfinite=False),
])
def test_a_mismatched_autosave_raises(tmp_path, change):
    path = _jax_autosave(tmp_path)[0]
    tapp = ControlTraining(N, _tpde(), **dict(_APP, **change)).prepare()
    before = [t.clone() for t in tapp._state()]
    with pytest.raises(ValueError, match="opt_state.msgpack"):
        tapp.restore_state(path)
    assert all(torch.equal(a, b) for a, b in zip(before, tapp._state()))


@pytest.mark.parametrize("clip, schedule, skip", [
    (1.0, "cosine", True), (None, None, True), (1.0, None, False),
    (None, "cosine", False)])
def test_opt_state_tree_is_the_jax_packages(clip, schedule, skip):
    kw = dict(grad_clip=clip, lr_schedule=schedule, skip_nonfinite=skip)
    _assert_trees_equal(_tapp(**kw)._opt_state(), _jax_tree(_japp(**kw)),
                        exact=False)
