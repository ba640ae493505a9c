"""The 128² indirect-smoke entries (`smoke_128`, `smoke_128_ft`) and the 3D
smoke entries (`smoke3d`, `smoke3d_ft`, `smoke3d_indirect`,
`smoke3d_indirect_ft`) of the port's CLI against the JAX
package's, on the CPU.

Held to:
* each entry, full size and `--smoke-test`, hands its experiment function
  the JAX package's arguments (both CLIs run with the experiment functions
  stubbed; the port adds only `device`), the plated 3D entries among
  them;
* `smoke_128 --smoke-test`'s datasets (32², n=4, 16 + 8 trajectories,
  the smoke task's two plates, pressure tol 1e-4 as configured) from the
  JAX package's draws against the JAX package's datasets: the
  trajectories and the post-warm-up velocity within 1e-4 of their scale
  (both solve the pressure to tol 1e-4 with CGs that sum in another
  order: up to 1.6e-5 in the post-warm-up velocity), the inflow
  exactly;
* the refusals that remain: `--mesh`, a fine-tune without
  `--init-from`, a flag an entry does not take.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pde_control_tpu.experiments.run as jrun
import pde_control_tpu.experiments.smoke3d as jsmoke3d
from pde_control_tpu.experiments import fluid2d as jfluid2d
from pde_control_tpu_torch.data import generate
from pde_control_tpu_torch.experiments import fluid2d, run, smoke3d

torch.set_num_threads(1)

_ENTRIES = {"smoke_128": "run_smoke_indirect",
            "smoke_128_ft": "run_smoke_indirect_ft",
            "smoke3d": "run_smoke3d", "smoke3d_ft": "run_smoke3d_ft",
            "smoke3d_indirect": "run_smoke3d_indirect",
            "smoke3d_indirect_ft": "run_smoke3d_indirect_ft"}


def _calls(argv, monkeypatch, port: bool):
    """The (args, kwargs) each CLI hands the entry's experiment function."""
    got = []

    def record(*a, **k):
        got.append((a, k))
        return {}

    name = argv[0]
    fn = _ENTRIES[name]
    module = ((smoke3d if port else jsmoke3d) if name.startswith("smoke3d")
              else (fluid2d if port else jfluid2d))
    monkeypatch.setattr(module, fn, record)
    with contextlib.redirect_stdout(io.StringIO()):
        if port:
            run.main(argv + ["--device", "cpu"])
        else:
            monkeypatch.setattr(jrun, "enable_compile_cache", lambda: None)
            monkeypatch.setattr("sys.argv", ["run"] + argv)
            jrun.main()
    assert len(got) == 1
    return got[0]


@pytest.mark.parametrize("argv", [
    ["smoke_128"], ["smoke_128", "--smoke-test"],
    ["smoke_128", "--width", "2", "--batch", "4", "--iterations", "3",
     "--e2e-iterations", "5", "--num-train", "24", "--seed", "2", "--resume",
     "--datadir", "d"],
    ["smoke_128_ft", "--init-from", "ck"],
    ["smoke_128_ft", "--smoke-test", "--init-from", "ck", "--force-reg",
     "1e-5"],
    ["smoke3d"], ["smoke3d", "--smoke-test"],
    ["smoke3d", "--iterations", "4", "--num-val", "6", "--seed", "1"],
    ["smoke3d_ft", "--init-from", "ck"],
    ["smoke3d_ft", "--smoke-test", "--init-from", "ck", "--e2e-iterations",
     "3"],
    ["smoke3d_indirect"], ["smoke3d_indirect", "--smoke-test"],
    ["smoke3d_indirect", "--iterations", "4", "--e2e-iterations", "6",
     "--num-train", "24", "--num-val", "6", "--seed", "1", "--resume"],
    ["smoke3d_indirect_ft", "--init-from", "ck"],
    ["smoke3d_indirect_ft", "--smoke-test", "--init-from", "ck",
     "--force-reg", "1e-5", "--e2e-iterations", "3"],
], ids=lambda a: " ".join(a))
def test_cli_dispatch_matches_jax(argv, monkeypatch):
    args, kw = _calls(argv, monkeypatch, port=True)
    jargs, jkw = _calls(argv, monkeypatch, port=False)
    assert kw.pop("device") == "cpu"
    assert jkw.pop("mesh") is None
    assert args == jargs and kw == jkw


@pytest.mark.parametrize("argv, message", [
    (["smoke3d_indirect", "--mesh", "2"], "needs a torchrun launch"),
    (["smoke3d_indirect_ft", "--init-from", "ck", "--mesh", "4"],
     "needs a torchrun launch"),
    (["smoke_128", "--mesh", "4"], "--mesh"),
    (["smoke_128_ft"], "requires --init-from"),
    (["smoke3d_ft"], "requires --init-from"),
    (["smoke3d", "--datadir", "d"], "--datadir is not supported"),
])
def test_cli_refuses(argv, message, capsys):
    with pytest.raises(SystemExit):
        run.main(argv + ["--device", "cpu"])
    assert message in capsys.readouterr().err


def _jax_draws(seed: int, num: int, w: int, batch: int = 8):
    """The draws `generate_inflow_smoke_dataset` makes from `seed`, chunk
    by chunk: the sources' x positions, then the modulation field's
    amplitudes and phases (3 modes)."""
    key = jax.random.PRNGKey(seed)
    out, remaining = [], num
    while remaining > 0:
        b = min(batch, remaining)
        key, k1, k2 = jax.random.split(key, 3)
        xs = jax.random.uniform(k1, (b, 1, 1), minval=0.15 * w,
                                maxval=0.85 * w)
        k_amp, k_phy, k_phx = jax.random.split(k2, 3)
        field = (jax.random.normal(k_amp, (b, 3, 3)),
                 jax.random.uniform(k_phy, (b, 3, 1), maxval=2 * jnp.pi),
                 jax.random.uniform(k_phx, (b, 3, 1), maxval=2 * jnp.pi))
        out.append((xs, field))
        remaining -= b
    return out


def test_smoke_128_smoke_test_datasets_match_jax(monkeypatch):
    size, n, num_train, num_val = 32, 4, 16, 8  # run.py's --smoke-test
    draws = iter(_jax_draws(0, num_train, size) + _jax_draws(999, num_val,
                                                            size))
    fields = []

    def inflow_draws(gen, b, w, x_range):
        xs, field = next(draws)
        fields.append(field)
        return torch.from_numpy(np.array(xs))

    monkeypatch.setattr(generate, "inflow_draws", inflow_draws)
    monkeypatch.setattr(generate, "smooth_field_draws", lambda gen, b: tuple(
        torch.from_numpy(np.array(a)) for a in fields[-1]))
    _, train, val = fluid2d._smoke_indirect_setup(size, n, num_train, num_val,
                                                  1.0, None, device="cpu")
    _, jtrain, jval = jfluid2d._smoke_indirect_setup(size, n, num_train,
                                                     num_val, 1.0, None)
    for got, want in ((train, jtrain), (val, jval)):
        assert got.obs.shape == want.obs.shape
        assert set(got.extras) == set(want.extras) == {"vy0", "vx0", "inflow"}
        np.testing.assert_allclose(got.extras["inflow"], want.extras["inflow"],
                                   rtol=0, atol=1e-7)
        for a, b in [(got.obs, want.obs)] + [(got.extras[k], want.extras[k])
                                             for k in ("vy0", "vx0")]:
            b = np.asarray(b)
            assert float(np.abs(a - b).max()) <= 1e-4 * float(np.abs(b).max())
    assert train.obs.shape == (num_train, n + 1, size, size, 1)
    assert np.abs(train.obs[:, n] - train.obs[:, 0]).max() > 1e-3
