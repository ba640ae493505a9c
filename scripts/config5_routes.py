"""Times config 5's curriculum stages on two routes, and predicts each
stage's wall time at the reference's counts from the parts.

    python3 scripts/config5_routes.py [--reps 3] [--profile e2e_n32]
        [--out FILE]

Config 5 (`fluid2d.run_natural_flow_128`: 64², n = 128, batch 8, blobs,
the staged horizons 32 -> 64 -> 128 with frames 32/64/96/128, cosine e2e
LR) from a cut dataset (16 + 8 trajectories), its stage apps built as
`curriculum.run_curriculum` builds them, random weights (seed 0), on
* the `default` route, the entry's: `_natural_flow_setup(...,
  pressure_backend='auto')`, so the unfused step with its exact spectral
  pressure solve and cuDNN convolutions;
* the `kernel` route: `fused='cuda', conv_impl='cuda',
  pressure_backend='cuda'`, i.e. K1 in the data and K2-K5 in training, the
  route of `chip_smoke.py`'s config-5 phase.

For each stage (CFE at n = 128, OP2, e2e at n = 32, 64, 128) it prints
* the first `progress_multi` call's seconds (warm-up steps, capture and
  instantiation of the step's CUDA graph, 8 replays), and the capture and
  instantiate seconds alone;
* `replay ms`: ms a step of K = 8 graph replays (one `progress_multi`
  call), by CUDA events, over `--reps` calls;
* `loop ms`: ms a step of `ControlTraining._train_fused`'s loop body
  (sample and upload the next K batches, then the call), by the host
  clock, the device synchronised at both ends;
* one log point's cost: `_render_progress` (an eager `infer_all_frames` at
  the stage's n, then the PNG and TensorBoard images), and the eager
  rollout alone;
* one autosave (`ControlTraining.autosave`);
* the predicted stage wall at the reference's counts (304 iterations a
  supervised stage, 4,504 an e2e horizon, a log point every 50 steps and
  an autosave every 500, as `_train_fused` places them): iterations x loop
  ms + autosaves x their cost + the first call, with and without the log
  points' renders, beside the seconds that a full-count run
  (`scripts/quality_torch.py config5`, its renders left out) measured.

With `--profile STAGE`, one `progress_multi` call of that stage on the
default route runs under `torch.profiler`: the device's busy share of the
call and its longest gaps between device operations.

Prints the card's name and power limit first, and a JSON summary last
(also written to `--out`).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from quality_torch import card_line  # noqa: E402

ROUTES = {
    "default": dict(pressure_backend="auto"),
    "kernel": dict(fused="cuda", conv_impl="cuda", pressure_backend="cuda"),
}
K = 8
LOG_EVERY, AUTOSAVE_EVERY = 50, 500
# Stage seconds of a full-count `quality_torch.py config5` run on an
# NVIDIA H100 80GB HBM3 at 700 W, the default route, the log points'
# renders left out (PERF.md §6). Its e2e n = 128 stage did not finish.
MEASURED_S = {"cfe": 178.6, "op2": 34.4, "e2e_n32": 557.4,
              "e2e_n64": 1096.6, "e2e_n128": None}


def stage_kwargs(name: str, n: int = 128) -> tuple[dict, int]:
    """`ControlTraining` kwargs of config 5's stage `name` and its
    iterations at the reference's counts, as `run_curriculum` builds it
    from `run_natural_flow_128`'s `CurriculumConfig`."""
    from pde_control_tpu_torch.experiments.curriculum import op_spans
    from pde_control_tpu_torch.experiments.fluid2d import _obs_frames

    if name == "cfe":
        return dict(n=n, trainable_networks=("CFE",), sequence_class="chain",
                    obs_loss_frames=tuple(range(1, n + 1)),
                    learning_rate=1e-3), 304
    if name.startswith("op"):
        return dict(n=n, trainable_networks=(f"OP{name[2:]}",),
                    sequence_class="op_supervised", learning_rate=1e-3), 304
    n_k = int(name.split("_n")[1])
    frames = tuple(sorted({f for f in _obs_frames(n) if f < n_k} | {n_k}))
    return dict(n=n_k, trainable_networks=("CFE",) + tuple(
        f"OP{s}" for s in op_spans(n_k)), sequence_class="staggered",
        obs_loss_frames=frames, learning_rate=1e-4, lr_schedule="cosine",
        decay_steps=4504), 4504


def points(iterations: int, every: int, at_end: bool) -> int:
    """The log points (`at_end`: also one after the last call) or the
    autosaves that `_train_fused` makes in a stage of `iterations` at K
    steps a call, one every `every` steps."""
    done, nxt, count = 0, every, 0
    while done < iterations:
        done += K
        if done >= nxt or (at_end and done >= iterations):
            while nxt <= done:
                nxt += every
            count += 1
    return count


def device_profile(app, batches) -> dict:
    """One `progress_multi` call under `torch.profiler`: the device's busy
    share of the span from its first device operation to its last, and the
    longest gaps between device operations, in ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        app.progress_multi(batches)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    if not spans:
        return {"device_ops": 0, "note": "the profiler saw no device time"}
    busy, gaps, end = 0.0, [], spans[0][0]
    for s, e in spans:
        if s > end:
            gaps.append(s - end)
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    span = end - spans[0][0]
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_ops": len(spans), "span_ms": span / 1e3,
            "busy_ms": busy / 1e3, "busy_share": busy / span,
            "gaps_ms": sorted((g / 1e3 for g in gaps), reverse=True)[:8],
            "gap_total_ms": sum(gaps) / 1e3,
            "top_device_ms": {k: v / 1e3 for k, v in top}}


def time_stage(route: str, name: str, task, reps: int, workdir: str,
               profile_it: bool) -> dict:
    from pde_control_tpu_torch.control.training import ControlTraining

    pde, train, val = task
    kw, iterations = stage_kwargs(name)
    app = ControlTraining(pde=pde, dataset=train, val_dataset=val,
                          batch_size=8, force_reg=1e-5, grad_clip=1.0,
                          seed=0, logdir=os.path.join(workdir, route, name),
                          **kw).prepare()
    sync = torch.cuda.synchronize
    cur = app.to_batch(app.sample_batches(K))
    sync()
    t0 = time.perf_counter()
    out = app.progress_multi(cur)
    sync()
    first_s = time.perf_counter() - t0
    graph = next(iter(app._graphs.values()))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    replay = []
    for _ in range(reps):
        start.record()
        out = app.progress_multi(cur)
        end.record()
        sync()
        replay.append(start.elapsed_time(end) / K)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        nxt = app.to_batch(app.sample_batches(K))
        out = app.progress_multi(cur)
        cur = nxt
    sync()
    loop_ms = (time.perf_counter() - t0) * 1e3 / (reps * K)
    last = {k: v[-1] for k, v in cur.items()}
    t0 = time.perf_counter()
    metrics = {k: float(v[-1]) for k, v in out.items()}
    app._render_progress(last)
    sync()
    render_s = time.perf_counter() - t0
    infer_s = 0.0  # `_render_progress` renders no supervised OP stage
    if app.sequence_class != "op_supervised":
        t0 = time.perf_counter()
        app.infer_all_frames(last)
        sync()
        infer_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    app.autosave(os.path.join(workdir, route, f"autosave_{name}"))
    sync()
    autosave_s = time.perf_counter() - t0
    logs = points(iterations, LOG_EVERY, at_end=True)
    saves = points(iterations, AUTOSAVE_EVERY, at_end=False)
    run = iterations if iterations % K == 0 else (iterations // K + 1) * K
    bare = run * loop_ms / 1e3 + saves * autosave_s + first_s
    rec = dict(route=route, stage=name, n=app.n,
               sequence_class=app.sequence_class, first_call_s=first_s,
               capture_s=graph.capture_s, instantiate_s=graph.instantiate_s,
               replay_ms=min(replay), replay_ms_all=replay, loop_ms=loop_ms,
               render_s=render_s, infer_s=infer_s, autosave_s=autosave_s,
               iterations=run, log_points=logs, autosaves=saves,
               predicted_s_no_render=bare,
               predicted_s=bare + logs * render_s,
               measured_s=MEASURED_S.get(name) if route == "default" else None,
               peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
               loss=metrics.get("loss"), launches=dict(graph.launches))
    print(f"{route:>7} {name:<9} first call {rec['first_call_s']:.2f} s "
          f"(capture {rec['capture_s']:.2f}, instantiate "
          f"{rec['instantiate_s']:.2f}), replay "
          f"{rec['replay_ms']:.3f} ms a step, loop "
          f"{rec['loop_ms']:.3f} ms, log point {rec['render_s']:.3f} s "
          f"(rollout {rec['infer_s']:.3f}), autosave "
          f"{rec['autosave_s']:.3f} s, peak {rec['peak_mib']:.1f} MiB; "
          f"{rec['iterations']} iterations, {rec['log_points']} log "
          f"points, {rec['autosaves']} autosaves: predicted "
          f"{rec['predicted_s_no_render']:.1f} s without renders, "
          f"{rec['predicted_s']:.1f} s with; measured "
          f"{rec['measured_s']}", flush=True)
    if profile_it:
        rec["profile"] = device_profile(app, cur)
    app.close()
    del app, graph, out, cur, nxt, last
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return rec


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--stages", default="cfe,op2,e2e_n32,e2e_n64,e2e_n128")
    p.add_argument("--routes", default="default,kernel")
    p.add_argument("--profile", default="e2e_n32",
                   help="a stage to profile on the default route ('' for none)")
    p.add_argument("--out", default=os.path.join(ROOT, "runs",
                                                 "config5_routes.json"))
    args = p.parse_args()
    card = card_line()
    print(card, flush=True)
    if not torch.cuda.is_available():
        sys.exit("config5_routes.py times the card: no CUDA device")
    from pde_control_tpu_torch.experiments import fluid2d

    records = []
    workdir = os.path.join(ROOT, "runs", "config5_routes")
    shutil.rmtree(workdir, ignore_errors=True)
    for route in args.routes.split(","):
        t0 = time.perf_counter()
        task = fluid2d._natural_flow_setup(64, 128, 16, 8, None,
                                           device="cuda", **ROUTES[route])
        torch.cuda.synchronize()
        print(f"{route} route: data (16 + 8 trajectories, 64², n = 128) "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        for name in args.stages.split(","):
            rec = time_stage(route, name, task, args.reps, workdir,
                             route == "default" and name == args.profile)
            records.append(rec)
            if "profile" in rec:
                print(f"profile of one call ({name}, {route}): "
                      f"{json.dumps(rec['profile'])}", flush=True)
        del task
        torch.cuda.empty_cache()
    by = {(r["route"], r["stage"]): r for r in records}
    for name in args.stages.split(","):
        d, k = by.get(("default", name)), by.get(("kernel", name))
        if d and k:
            print(f"{name:<9} default / kernel replay {d['replay_ms']:.3f} / "
                  f"{k['replay_ms']:.3f} ms ({d['replay_ms'] / k['replay_ms']:.2f}x)"
                  f"; default predicted {d['predicted_s_no_render']:.1f} s, "
                  f"measured {d['measured_s']}", flush=True)
    summary = {"card": card, "records": records}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(card, flush=True)
    print(json.dumps({"card": card, "stages": [
        {k: r[k] for k in ("route", "stage", "replay_ms", "loop_ms",
                           "render_s", "predicted_s_no_render", "measured_s")}
        for r in records]}))


if __name__ == "__main__":
    main()
