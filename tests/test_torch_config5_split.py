"""Config 5's curriculum split over calls by its stage checkpoints, on the
CPU, through `scripts/quality_torch.py`'s hooks (`split_run`).

`fluid2d.run_natural_flow_128` at a cut size (16², n = 64, so that the
e2e horizons 32 and 64 exist; 8 + 4 trajectories, batch 2, 8 iterations a
stage) runs once whole, and once in two calls: the first stops after the
e2e n = 32 stage with its checkpoints copied out; the second starts in a
fresh run directory that holds only the copied `ckpt_*`, makes the data
again and resumes. Each stage's app is seeded anew, so a stage-level
resume draws the same streams: the two eval blocks agree to 1e-6
relative, and the datasets' digests are equal in all three runs.
"""

from __future__ import annotations

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "quality_torch", os.path.join(ROOT, "scripts", "quality_torch.py"))
quality = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(quality)

KW = dict(size=16, n=64, iterations=8, e2e_iterations=8, num_train=8,
          num_val=4, batch_size=2, seed=0, device="cpu")
EVAL_KEYS = ("final_state_mse", "final_state_mse_sem", "zero_force_final_mse",
             "mean_abs_force", "mean_force_cost", "per_frame_mse",
             "per_frame_zero_force_mse")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from pde_control_tpu_torch.experiments import fluid2d

    base = tmp_path_factory.mktemp("config5_split")
    whole_dir, save_to = str(base / "whole"), str(base / "call1_out")
    call2_dir = str(base / "call2")
    # The cut shapes are small enough that one thread runs them fastest.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with quality.split_run(whole_dir) as whole_state:
            whole = fluid2d.run_natural_flow_128(whole_dir, **KW)
        with quality.split_run(str(base / "call1"), save_to=save_to,
                               stop_after="end_to_end_n32") as call1:
            with pytest.raises(quality.StopAfterStage):
                fluid2d.run_natural_flow_128(str(base / "call1"), **KW)
        saved = sorted(os.listdir(save_to))
        with quality.split_run(call2_dir, resume_from=save_to) as call2:
            resumed = fluid2d.run_natural_flow_128(call2_dir, resume=True,
                                                   **KW)
    finally:
        torch.set_num_threads(threads)
    return dict(whole=whole, whole_digests=whole_state["digests"],
                call1=call1, saved=saved, save_to=save_to, call2=call2,
                call2_listing=sorted(n for n in os.listdir(call2_dir)
                                     if n.startswith(("ckpt_", "autosave_"))),
                resumed=resumed)


def test_split_eval_equals_whole(runs):
    whole, resumed = runs["whole"]["eval"], runs["resumed"]["eval"]
    for key in EVAL_KEYS:
        np.testing.assert_allclose(resumed[key], whole[key], rtol=1e-6,
                                   atol=0, err_msg=key)
    assert resumed["eval_samples"] == whole["eval_samples"] == 4


def test_split_digests_equal(runs):
    digests = runs["whole_digests"]
    assert set(digests) == {"train", "val"}
    assert runs["call1"]["digests"] == digests
    assert runs["call2"]["digests"] == digests
    with open(os.path.join(runs["save_to"], "digests.json")) as f:
        assert json.load(f) == digests


def test_stop_after_copies_checkpoints_and_records(runs):
    assert runs["saved"] == ["ckpt_cfe", "ckpt_e2e_n32", "ckpt_ops",
                             "digests.json", "stages.json"]
    assert all(os.path.exists(os.path.join(runs["save_to"], "ckpt_ops",
                                           f"OP{s}.msgpack"))
               for s in (2, 4, 8, 16, 32, 64))
    assert runs["call2_listing"] == ["ckpt_cfe", "ckpt_e2e_n32",
                                     "ckpt_e2e_n64", "ckpt_final", "ckpt_ops"]
    earlier = runs["call2"]["earlier"]
    assert sorted(earlier) == sorted(
        ["cfe_supervised", "end_to_end_n32"]
        + [f"op{s}_supervised" for s in (2, 4, 8, 16, 32, 64)])
    assert all(earlier[k]["iterations_run"] == 8 for k in earlier)
    # The second call trained only e2e n = 64; merge_earlier fills the rest
    # with the first call's records, as the whole run's.
    resumed = runs["resumed"]
    assert resumed["end_to_end_n32"] == {"resumed": True}
    assert resumed["end_to_end_n64"]["iterations_run"] == 8
    merged = quality.merge_earlier(resumed, earlier)
    for key in earlier:
        assert merged[key]["from_earlier_call"]
        np.testing.assert_allclose(merged[key]["loss"],
                                   runs["whole"][key]["loss"], rtol=1e-6)


def test_resume_copies_only_checkpoints(tmp_path):
    """`--resume-from` copies `ckpt_*` and `autosave_*` (a `.old` only where
    its copy is missing, no `.tmp`) and nothing else, e.g. not the data."""
    src = tmp_path / "out"
    for name in ("ckpt_cfe", "ckpt_ops.old", "ckpt_e2e_n32",
                 "ckpt_e2e_n32.old", "autosave_e2e_n64.tmp",
                 "autosave_e2e_n128", "data", "logs_cfe"):
        (src / name).mkdir(parents=True)
        (src / name / "x").write_text(name)
    work = tmp_path / "work"
    with quality.split_run(str(work), resume_from=str(src)):
        pass
    assert sorted(os.listdir(work)) == ["autosave_e2e_n128", "ckpt_cfe",
                                        "ckpt_e2e_n32", "ckpt_ops"]
    assert (work / "ckpt_ops" / "x").read_text() == "ckpt_ops.old"
    assert (work / "ckpt_e2e_n32" / "x").read_text() == "ckpt_e2e_n32"
