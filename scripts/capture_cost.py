"""Times the CUDA-graph capture and instantiation of the plated 3D task's
supervised CFE step several times in one process, on one NVIDIA GPU, with
Python's cyclic garbage collector on and off in turns.

    python3 scripts/capture_cost.py [--captures 5]

The step is `smoke3d_indirect`'s first stage at its full width (32³ with
the plate, n=16, batch 8, the CFE trained on the chain loss; 31 3D CG
solves of 200 trips each under the capture), built as `run_curriculum`
builds it, on 8 + 8 trajectories (their count does not change the step).
Each capture goes through `ControlTraining._step_graph` (its warm-up
steps, the capture and the instantiation) after the previous graph is
dropped. For each: the host seconds of the three (`_StepGraph.capture_s`,
`instantiate_s`), the graph's nodes (`chip_smoke._graph_nodes`), the
collections the GC ran by generation and their seconds
(`gc.callbacks`), the process's resident host memory (VmRSS) and the
card's reserved memory after it. One JSON line a capture, then the card's
name and power limit. It checks nothing: `chip_smoke.py` holds the
captured solve to the eager one.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from pde_control_tpu_torch.control.training import ControlTraining  # noqa: E402
from pde_control_tpu_torch.experiments import smoke3d  # noqa: E402
from pde_control_tpu_torch.experiments.curriculum import (  # noqa: E402
    CurriculumConfig,
)


def _rss_mib() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--captures", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    n, batch = 16, 8
    pde, train, val = smoke3d._smoke3d_indirect_setup(32, n, 8, 8,
                                                      device="cuda")
    cfg = CurriculumConfig(n=n, batch_size=batch, force_reg=3e-5,
                           grad_clip=1.0)
    app = ControlTraining(
        n, trainable_networks=("CFE",), sequence_class="chain",
        obs_loss_frames=tuple(range(1, n + 1)), learning_rate=cfg.cfe_lr,
        pde=pde, dataset=train, val_dataset=val, batch_size=batch,
        force_reg=cfg.force_reg, grad_clip=cfg.grad_clip,
        seed=cfg.seed).prepare()
    batches = app.to_batch(app.sample_batches(1))
    for i in range(args.captures):
        gc_on = i % 2 == 0
        app._graphs.clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        rss_before = _rss_mib()
        collections, gc_s, started = [0, 0, 0], [0.0], [0.0]

        def count(phase, info):
            if phase == "start":
                collections[info["generation"]] += 1
                started[0] = time.perf_counter()
            else:
                gc_s[0] += time.perf_counter() - started[0]

        gc.callbacks.append(count)
        if not gc_on:
            gc.disable()
        t0 = time.perf_counter()
        try:
            graph = app._step_graph(batches)
        finally:
            gc.enable()
            gc.callbacks.remove(count)
        total = time.perf_counter() - t0
        print(json.dumps({
            "capture": i, "gc": gc_on, "total_s": total,
            "capture_s": graph.capture_s,
            "instantiate_s": graph.instantiate_s,
            "nodes": chip_smoke._graph_nodes(graph.graph),
            "collections": collections, "gc_s": gc_s[0],
            "rss_mib_before": rss_before, "rss_mib_after": _rss_mib(),
            "reserved_mib": torch.cuda.memory_reserved() / 2**20}),
            flush=True)
        del graph
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
