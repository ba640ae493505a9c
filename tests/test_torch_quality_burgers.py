"""`scripts/quality_torch.py compare_burgers` on the CPU: the port's
`compare_schemes.compare_burgers` on the JAX package's Burgers draws
(`tests/goldens/jax_draws_burgers.npz`), through the script's runner, at a
cut count: one training chunk (64 trajectories), the full 128 validation
trajectories, 8 iterations a stage and 8 adjoint iterations.

The zero-force columns use no network: on the JAX package's draws they
hold the comparison's data path to its published `comparison.json`
(`artifacts/runs/compare_burgers`) within the Burgers data-path tolerance
of 1e-4 relative: the scheme rows' 4.469886e-02 over the 128 validation
trajectories and the `zero_force` row's 4.723959e-02 over the first 32
(`compare_schemes._eval_batch`). Measured on the CPU: 9.2e-7 and 3.4e-6.
The trained rows are far from the published ones at 8 iterations; only
their shape is held here.

Budget: ~40 s of one worker.
"""

from __future__ import annotations

import importlib.util
import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "quality_torch", os.path.join(ROOT, "scripts", "quality_torch.py"))
quality = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(quality)

COUNTS = dict(iterations=8, e2e_iterations=None, num_train=64, num_val=128,
              adjoint_iterations=8)


@pytest.fixture(scope="module")
def comparison(tmp_path_factory):
    """One cut run: the rows, and the published ones."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        results = quality.run_jax_draws(
            "compare_burgers", COUNTS, "cpu",
            str(tmp_path_factory.mktemp("compare_burgers")))
    finally:
        torch.set_num_threads(threads)
    with open(os.path.join(quality.RUNS, "compare_burgers",
                           "comparison.json")) as f:
        return results, json.load(f)


def test_zero_force_is_the_published(comparison):
    got, ref = comparison
    for scheme in quality.SCHEMES:
        assert ref[scheme]["zero_force_final_mse"] == pytest.approx(
            4.469886e-02, rel=1e-6)
        assert got[scheme]["zero_force_final_mse"] == pytest.approx(
            ref[scheme]["zero_force_final_mse"], rel=1e-4), scheme
        assert got[scheme]["eval_samples"] == 128
    assert ref["zero_force"]["final_state_mse"] == pytest.approx(
        4.723959e-02, rel=1e-6)
    assert got["zero_force"]["final_state_mse"] == pytest.approx(
        ref["zero_force"]["final_state_mse"], rel=1e-4)


def test_rows_and_checks(comparison):
    """Every row the published table has, the adjoint row at the cut's
    iterations on the first 32 trajectories, and the script's checks on
    them: the zero force holds, the untrained rows are out of their
    bands, and no launch is counted on the CPU."""
    got, ref = comparison
    assert set(ref) - {"vm_epoch"} <= set(got)
    assert got["adjoint"]["iterations"] == 8
    assert got["adjoint"]["num_trajectories"] == 32
    assert not any(got["launches"].values())
    c = quality.scheme_checks(got, ref)
    assert c["zero_force_matches"]
    assert set(c["zero_force_rel_err"]) == {*quality.SCHEMES, "zero_force"}
    assert not c["schemes_in_band"] and not c["adjoint_matches"]
    assert all(r["side"] == "above" for r in c["rows"].values())
    assert c["jax_chain_over_staggered"] == pytest.approx(9.6215, rel=1e-4)
    assert c["jax_staggered_over_adjoint"] == pytest.approx(2.7776, rel=1e-4)
