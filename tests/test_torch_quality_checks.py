"""`scripts/quality_torch.py`'s checks of `compare_burgers` and `--ood`,
on synthetic results with no training, and its draws' guards: the zero
force's tolerances (1e-4 relative for Burgers, 1e-2 for the OOD rows), the
adjoint's 5%, the bands (±25% around a JAX row or the mean of two JAX
runs, ±30% around one), the in-distribution row against the same nets'
eval, `RESULTS.md`'s findings, the refusal of a seed that no split holds,
of a source band that is not the draws', of a chunk of another size and
of a pop past a file's end, `check_pops` over the OOD splits (generalize_smoke
makes `in_dist` twice), and the command line's refusals.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from pde_control_tpu_torch.data import generate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "quality_torch", os.path.join(ROOT, "scripts", "quality_torch.py"))
quality = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(quality)


def _comparison() -> dict:
    with open(os.path.join(quality.RUNS, "compare_burgers",
                           "comparison.json")) as f:
        return json.load(f)


def test_scheme_checks():
    ref = _comparison()
    c = quality.scheme_checks(ref, ref)
    assert c["zero_force_matches"] and c["adjoint_matches"]
    assert c["schemes_in_band"] and c["chain_worst"]
    assert c["adjoint_below_schemes"]
    assert c["chain_over_staggered"] == c["jax_chain_over_staggered"]
    assert c["chain_worst_by"] == pytest.approx(8.5599e-05 / 1.2781e-05,
                                                rel=1e-4)
    got = copy.deepcopy(ref)
    got["refined"]["zero_force_final_mse"] *= 1 + 2e-4
    got["adjoint"]["final_state_mse"] *= 1.06
    got["chain_final"]["final_state_mse"] *= 1.3
    got["staggered"]["final_state_mse"] *= 0.7
    c = quality.scheme_checks(got, ref)
    assert not c["zero_force_matches"] and not c["adjoint_matches"]
    assert c["zero_force_rel_err"]["refined"] == pytest.approx(2e-4)
    assert c["zero_force_rel_err"]["zero_force"] == 0
    assert [c["rows"][s]["side"] for s in quality.SCHEMES] == [
        "above", "below", "inside"]
    got["adjoint"]["final_state_mse"] = ref["adjoint"]["final_state_mse"] * 0.96
    got["zero_force"]["final_state_mse"] *= 1 + 5e-5
    got["chain_final"]["final_state_mse"] = 2 * ref["refined"]["final_state_mse"]
    c = quality.scheme_checks(got, ref)
    assert c["adjoint_matches"] and not c["chain_worst"]
    assert c["zero_force_rel_err"]["zero_force"] == pytest.approx(5e-5)


def test_ood_checks():
    refs = quality.ood_refs("config3")
    seed0 = {k: dict(v) for k, v in refs[1].items() if isinstance(v, dict)}
    same = dict(seed0["shapes"])
    c = quality.ood_checks("config3", seed0, refs, same, same)
    assert c["zero_force_matches"] and c["in_dist_equal"]
    assert c["findings"] == {"shapes > crosses > rings by ratio": True}
    # Two JAX runs: ±25% around their mean; one (the chain rows): ±30%.
    lo, hi = c["rows"]["shapes"]["band"]
    mean = (refs[0]["shapes"]["final_state_mse"]
            + refs[1]["shapes"]["final_state_mse"]) / 2
    assert (lo, hi) == pytest.approx((0.75 * mean, 1.25 * mean))
    chain = refs[1]["crosses_chain"]["final_state_mse"]
    assert c["rows"]["crosses_chain"]["band"] == pytest.approx(
        [0.7 * chain, 1.3 * chain])
    assert c["rows"]["crosses_chain"]["chain"]
    assert not c["rows"]["crosses"]["chain"]
    seed0["rings"]["zero_force_final_mse"] *= 1.02
    seed0["crosses"]["final_state_mse"] *= 2
    seed0["crosses"]["ratio_vs_zero_force"] = 5.0
    c = quality.ood_checks("config3", seed0, refs, dict(
        same, final_state_mse=same["final_state_mse"] * (1 + 2e-4)), same)
    assert not c["zero_force_matches"] and not c["in_dist_equal"]
    assert c["rows"]["crosses"]["side"] == "above"
    assert c["in_dist_gaps"]["final_state_mse"]["training_eval"] == 0
    assert c["findings"] == {"shapes > crosses > rings by ratio": False}

    refs = quality.ood_refs("config4")
    rows = {k: dict(v) for k, v in refs[0].items() if isinstance(v, dict)}
    c = quality.ood_checks("config4", rows, refs, rows["in_dist"],
                           rows["in_dist"])
    assert c["zero_force_matches"] and c["controlled_in_band"]
    assert all(c["findings"].values()) and len(c["findings"]) == 2
    ind = rows["in_dist"]["final_state_mse"]
    assert c["rows"]["in_dist"]["band"] == pytest.approx([0.7 * ind, 1.3 * ind])
    assert [k for k, r in c["rows"].items() if r["chain"]] == [
        "in_dist_chain", "horizon_24", "horizon_32"]
    rows["inflow_shifted"]["ratio_vs_zero_force"] = 6.0
    rows["obstacles_ood"]["ratio_vs_zero_force"] = 30.0
    c = quality.ood_checks("config4", rows, refs, rows["in_dist"],
                           rows["in_dist"])
    assert not any(c["findings"].values())


def test_patch_draws_guards():
    original = (generate.inflow_draws, generate.smooth_field_draws,
                dict(generate.INITS))
    with quality.patch_draws("ood_smoke") as (pops, z):
        with pytest.raises(KeyError, match="12345"):
            generate.inflow_draws(torch.Generator().manual_seed(12345), 8, 64)
        shifted = torch.Generator().manual_seed(2999)
        with pytest.raises(ValueError, match="inflow_shifted"):
            generate.inflow_draws(shifted, 8, 64)
        xs = generate.inflow_draws(shifted, 8, 64, (0.05, 0.30))
        np.testing.assert_array_equal(xs.numpy(), z["inflow_shifted/xs"][0])
        gen = torch.Generator().manual_seed(999)
        with pytest.raises(ValueError, match="chunks of 8"):
            generate.smooth_field_draws(gen, 4)
        for i in range(4):
            amps, _, _ = generate.smooth_field_draws(gen, 8)
            np.testing.assert_array_equal(amps.numpy(), z["in_dist/amps"][i])
        with pytest.raises(IndexError, match="pop 5 of 4"):
            generate.smooth_field_draws(gen, 8)
        # A second set from the same seed pops its draws from the first.
        again = torch.Generator().manual_seed(999)
        amps, _, _ = generate.smooth_field_draws(again, 8)
        np.testing.assert_array_equal(amps.numpy(), z["in_dist/amps"][0])
    assert pops == {("inflow_shifted", "inflow"): 1, ("in_dist", "field"): 5}
    assert (generate.inflow_draws, generate.smooth_field_draws,
            generate.INITS) == original


def test_check_pops_over_ood_splits():
    counts = dict(num_train=0, num_val=32)
    z = dict(np.load(os.path.join(quality.GOLDENS,
                                  "jax_draws_ood_smoke.npz")))
    cases = ("in_dist", "obstacles_ood", "inflow_shifted", "horizon_24",
             "horizon_32")
    pops = {(c, k): 4 * (2 if c == "in_dist" else 1)
            for c in cases for k in ("inflow", "field")}
    quality.check_pops(pops, z, counts, quality.OOD["config4"]["sets"])
    with pytest.raises(AssertionError, match="the counts need"):
        quality.check_pops(pops, z, counts)  # in_dist made once
    short = {**pops, ("horizon_32", "field"): 3}
    with pytest.raises(AssertionError):
        quality.check_pops(short, z, counts, quality.OOD["config4"]["sets"])
    z = dict(np.load(os.path.join(quality.GOLDENS,
                                  "jax_draws_ood_shapes.npz")))
    # Two force fields a chunk; 8 trajectories a case: one chunk.
    pops = {(f, k): n for f in ("shapes", "crosses", "rings")
            for k, n in ((f, 1), ("field", 2))}
    quality.check_pops(pops, z, dict(num_train=0, num_val=8),
                       quality.OOD["config3"]["sets"])


@pytest.mark.parametrize("argv", [
    ["config5", "--ood"], ["config4", "--ood", "--draws", "port"],
    ["compare_burgers", "--draws", "port"],
    ["config4", "--adjoint-iterations", "8"],
    ["compare_burgers", "--save-to", "x"], ["config2", "--seed", "1"],
    ["config4", "--seed", "1", "--draws", "port"]])
def test_command_line_refusals(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["quality_torch.py", *argv])
    with pytest.raises(SystemExit) as e:
        quality.main()
    assert e.value.code == 2
