"""`scripts/quality_torch.py --route kernel` on the CPU: configs 4 and 5
trained through their entries with the setups given `fused='cuda',
conv_impl='cuda'` (and on config 5 `pressure_backend='cuda'`) by the
script's hook (`kernel_route`), against the default route.

On the CPU the kernels' wrappers run their plain versions, so these
tests hold the route's wiring and the two routes' results against each
other at a cut size (16², 8 + 4 trajectories, batch 2, 8 iterations a
stage), not the kernels. The kernel route's training iteration is held to
the JAX package by `tests/test_torch_conv.py`'s 16² iteration under
`fused='cuda', conv_impl='cuda'` against the JAX package's
`conv_impl='pallas'` (`test_iteration_loss_matches_pallas` and the tests
after it); its kernels are held to their plain versions on the card by
`chip_smoke.py`.

The tolerances, each measured on the CPU at this size:
* config 4's data is made on the default route on both, so the digests
  are equal; its zero force differs only by the training PDE's physics
  in the eval (the fused step's plain version against the unfused step,
  both PCG at tol 1e-4): 1e-3 relative is asked, 1.2e-7 measured;
* config 4's controlled MSE after 8 iterations in each of its 4 stages:
  the routes differ by the fused step's and the bf16 convs' rounding,
  carried through 32 Adam steps; 4.2e-5 relative measured, held to 1e-3;
* config 5's zero force: the data and the eval's physics on the PCG
  (tol 1e-4) in place of the exact spectral solve; 1e-2 relative is
  asked, 6.4e-7 measured.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "quality_torch", os.path.join(ROOT, "scripts", "quality_torch.py"))
quality = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(quality)

KW = dict(size=16, iterations=8, e2e_iterations=8, num_train=8, num_val=4,
          batch_size=2, seed=0, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The cut shapes run fastest on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(entry: str, workdir: str, route: str, **kw) -> dict:
    """One run of `fluid2d.<entry>` on `route`, under the script's hooks:
    its results, the datasets' digests and the route's records."""
    from pde_control_tpu_torch.experiments import fluid2d

    config = "config4" if entry == "run_smoke_indirect" else "config5"
    with (quality.kernel_route(config, "cpu") if route == "kernel"
          else contextlib.nullcontext({})) as rec, \
            quality.split_run(workdir) as state:
        results = getattr(fluid2d, entry)(workdir, **KW, **kw)
    return dict(results=results, digests=dict(state["digests"]), route=rec,
                workdir=workdir)


def _routed_stages(run: dict) -> list:
    """The stages whose results carry the kernel route's launches."""
    return [s for s, v in run["results"].items() if s != "end_to_end"
            and isinstance(v, dict) and "launches" in v]


@pytest.fixture(scope="module")
def config4(tmp_path_factory):
    base = tmp_path_factory.mktemp("route4")
    return {route: _run("run_smoke_indirect", str(base / route), route, n=4)
            for route in ("default", "kernel")}


@pytest.fixture(scope="module")
def config5(tmp_path_factory):
    base = tmp_path_factory.mktemp("route5")
    return {route: _run("run_natural_flow_128", str(base / route), route, n=8,
                        datadir=str(base / route / "data"))
            for route in ("default", "kernel")}


def test_route_setups_and_configs_refused(monkeypatch):
    from pde_control_tpu_torch.experiments import fluid2d

    setups = {"config4": lambda: fluid2d._smoke_indirect_setup(
                  16, 2, 8, 4, 1.0, None, device="cpu"),
              "config5": lambda: fluid2d._natural_flow_setup(
                  16, 2, 8, 4, None, device="cpu")}
    originals = (fluid2d._smoke_indirect_setup, fluid2d._natural_flow_setup)
    for config, setup in setups.items():
        pde = setup()[0]
        assert (pde.cfg.fused, pde.conv_impl, pde.cfg.pressure_backend) == (
            "auto", "xla", "auto"), config
        with quality.kernel_route(config, "cpu") as rec:
            pde = setup()[0]
        assert (pde.cfg.fused, pde.conv_impl) == ("cuda", "cuda"), config
        assert pde.cfg.pressure_backend == (
            "cuda" if config == "config5" else "auto"), config
        # Both sets were made (no disk cache); no launch is counted on the
        # CPU.
        assert rec["data"]["generated"] == ["train", "val"]
        assert not any(rec["data"]["launches"].values())
        assert (fluid2d._smoke_indirect_setup,
                fluid2d._natural_flow_setup) == originals
    for config in ("config1", "config2", "config3"):
        monkeypatch.setattr(sys, "argv", ["quality_torch.py", config,
                                          "--route", "kernel"])
        with pytest.raises(SystemExit) as e:
            quality.main()
        assert e.value.code == 2, config
    monkeypatch.setattr(sys, "argv", ["quality_torch.py", "config4", "--route",
                                      "kernel", "--draws", "port"])
    with pytest.raises(SystemExit):
        quality.main()


def test_config4_routes(config4):
    default, kernel = config4["default"], config4["kernel"]
    assert kernel["digests"] == default["digests"]
    assert set(default["digests"]) == {"train", "val"}
    d, k = default["results"]["eval"], kernel["results"]["eval"]
    assert k["zero_force_final_mse"] == pytest.approx(
        d["zero_force_final_mse"], rel=1e-3)
    assert k["final_state_mse"] == pytest.approx(d["final_state_mse"],
                                                 rel=1e-3)
    # Every stage the kernel route trained carries its launches (zero on
    # the CPU) and the default route's none.
    assert _routed_stages(kernel) == ["cfe_supervised", "op2_supervised",
                                      "op4_supervised", "end_to_end_n4"]
    for stage in _routed_stages(kernel):
        assert set(kernel["results"][stage]["launches"]) == {
            "K1", "K2", "K3", "K4 fwd", "K4 dX", "K5"}
        assert "launches" not in default["results"][stage]
        assert kernel["results"][stage]["notfinite_total"] == 0


def test_config5_routes(config5):
    default, kernel = config5["default"], config5["kernel"]
    # The cache keys differ by the pressure solve alone; so does the data.
    keys = {}
    for route in ("default", "kernel"):
        with open(os.path.join(config5[route]["workdir"], "data", "train",
                               "manifest.json")) as f:
            keys[route] = json.loads(json.load(f)["params_key"])
    assert keys["default"] != keys["kernel"]
    assert keys["default"]["physics"].pop("pressure_backend") == "auto"
    assert keys["kernel"]["physics"].pop("pressure_backend") == "cuda"
    assert keys["default"] == keys["kernel"]
    assert kernel["digests"] != default["digests"]
    assert _routed_stages(kernel) == [
        "cfe_supervised", "op2_supervised", "op4_supervised",
        "op8_supervised", "end_to_end_n8"]
    d, k = default["results"]["eval"], kernel["results"]["eval"]
    assert k["zero_force_final_mse"] == pytest.approx(
        d["zero_force_final_mse"], rel=1e-2)
