"""render_rollout, the profiling hooks, profile_bench and the viz color
maps of the port, on the CPU.

* `render_rollout.render('smoke_indirect')` at 16² (the module's `SIZE`
  patched) from a checkpoint with a perturbed CFE: the four strips are
  written, and the printed controlled MSE equals `evaluate_control`'s
  final-state MSE for that sample (rtol 1e-5).
* `utils/profiling.trace` writes a Chrome trace holding a `named` range;
  `enable_nan_checks` turns autograd's anomaly detection on and off.
* `profile_bench.run` at 16², n=4, batch 2 times every phase (a positive
  time, the host clock named) and counts the step's FLOPs; its CLI prints
  a line a phase, or one JSON object with `--json`; the mfu is left
  unmeasured off the card.
* `utils/viz.py`: 'magma' and 'viridis' give other pixels; an unknown map
  raises.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from pde_control_tpu_torch.data.scene import TrajectoryDataset
from pde_control_tpu_torch.experiments import profile_bench, render_rollout
from pde_control_tpu_torch.experiments.curriculum import evaluate_control
from pde_control_tpu_torch.utils import profiling, viz

torch.set_num_threads(1)


def test_render_smoke_indirect(tmp_path, monkeypatch):
    monkeypatch.setattr(render_rollout, "SIZE", 16)
    # A checkpoint of the task's nets (built where there is none to
    # restore), the CFE's output layer perturbed so that the controlled
    # rollout differs from the zero-force one.
    wd = str(tmp_path / "run")
    app, val, n, _ = render_rollout._build("smoke_indirect", str(tmp_path),
                                           device="cpu")
    w = app.nets["CFE"].Conv_4.weight
    with torch.no_grad():
        w.copy_(0.05 * torch.from_numpy(
            np.random.default_rng(5).normal(size=tuple(w.shape))).float())
    app.save(os.path.join(wd, "ckpt_final"))
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = render_rollout.render("smoke_indirect", wd, sample=3,
                                    device="cpu")
    assert "controlled final MSE" in out.getvalue()
    outdir = os.path.join(wd, "renders")
    for name in ("controlled", "ground_truth", "zero_force", "force_magnitude"):
        assert os.path.getsize(os.path.join(outdir, f"{name}.png")) > 0, name
    # evaluate_control on that one sample (render draws 8 with seed 7)
    idx = np.random.default_rng(7).integers(0, len(val), size=8)[3]
    app, _, _, _ = render_rollout._build("smoke_indirect", wd, device="cpu")
    one = TrajectoryDataset(val.obs[idx:idx + 1],
                            **{k: v[idx:idx + 1] for k, v in val.extras.items()})
    ev = evaluate_control(app, one, n)
    np.testing.assert_allclose(res["controlled_mse"], ev["final_state_mse"],
                               rtol=1e-5)
    np.testing.assert_allclose(res["zero_force_mse"],
                               ev["zero_force_final_mse"], rtol=1e-5)
    assert res["controlled_mse"] != res["zero_force_mse"]


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.named("the_range"):
            torch.ones(8).cumsum(0)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "the_range" for e in events)


def test_enable_nan_checks():
    try:
        profiling.enable_nan_checks()
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1.0).sum().backward()
    finally:
        profiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


PHASES = ("train_step_full", "train_step_graph", "forward_loss",
          "physics_rollout_fwd", "physics_rollout_fwd_bwd", "fluid_step_fwd",
          "advection_only_fwd", "projection_only_fwd", "op_tree_fwd",
          "cfe_chain_with_physics_fwd", "cfe_nets_only_fwd_x16",
          "optimizer_update")


def test_profile_bench_times_every_phase(monkeypatch):
    res = profile_bench.run("cpu", h=16, n=4, b=2, blocks=2, inner=1)
    assert set(res) == set(PHASES) | {"flops_per_step"}
    for key in PHASES:
        t = res[key]
        assert t["ms"] > 0 and t["min"] <= t["ms"] <= t["max"], key
        assert t["clock"] == "host clock", key
    assert res["train_step_full"]["mfu"] is None
    f = res["flops_per_step"]
    assert f["nets"] > 0 and f["stencils"] > 0
    assert f["total"] == f["nets"] + f["stencils"]
    text = profile_bench.lines(res, "cpu, host clock")
    assert len(text) == len(PHASES) + 1
    assert all(line.startswith(k) for line, k in zip(text, PHASES))
    assert "mfu not measured" in text[0]
    monkeypatch.setattr(profile_bench, "run", lambda device, h: res)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        profile_bench.main(["--json", "--device", "cpu"])
    printed = json.loads(out.getvalue())
    assert printed["device"] == "cpu, host clock"
    assert printed["train_step_full"]["ms"] == res["train_step_full"]["ms"]


def test_viz_color_maps(tmp_path):
    field = np.linspace(0, 1, 64, dtype=np.float32).reshape(8, 8)
    a = viz._colorize(field, 0.0, 1.0, "viridis")
    b = viz._colorize(field, 0.0, 1.0, "magma")
    assert a.shape == b.shape == (8, 8, 3) and (a != b).any()
    np.testing.assert_array_equal(b[0, 0], [0, 0, 4])
    np.testing.assert_array_equal(b[-1, -1], [252, 253, 191])
    frames = np.stack([field, 2 * field])
    viz.save_trajectory_strip(frames, str(tmp_path / "v.png"))
    viz.save_trajectory_strip(frames, str(tmp_path / "m.png"), cmap="magma")
    assert (tmp_path / "v.png").read_bytes() != (tmp_path / "m.png").read_bytes()
    with pytest.raises(ValueError, match="unknown cmap"):
        viz.save_field_png(field, str(tmp_path / "x.png"), cmap="jet")
