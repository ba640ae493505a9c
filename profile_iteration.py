"""Where the time of the port's training iteration goes, on one NVIDIA GPU.

    python3 profile_iteration.py

For each path (the unfused step with the pressure solve on its kernel; the
fused step, `FluidConfig.fused='cuda'`; and the fused step with the nets'
3×3 stride-1 convs on the hand-written kernels, `conv_impl='cuda'`),
builds the 64² main path of `chip_smoke.make_app`, warms it up, and
prints:
  * the phase split: the OP tree's forward alone, the forward with its
    autograd graph, forward and backward, the Adam update, and the whole
    iteration; host clock around synchronised calls, best of 3;
  * one iteration under `torch.profiler` (CPU and CUDA): the wall time
    under the profiler, the device operations, the kernel launches
    (`cudaLaunchKernel` calls), the device's busy time (the union of the
    device operations' intervals) and its share, the device time of the
    convolutions (the port's conv kernels, and cuDNN's kernels with their
    layout transforms), and the top items by device time and by host
    time, as tables.
Every line names the card and its power limit.
"""

from __future__ import annotations

import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke


def _best_ms(fn, reps: int = 3) -> float:
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, 1e3 * (time.perf_counter() - t0))
    return best


def _busy_us(events) -> float:
    """Length of the union of the intervals of `events`."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


# Substrings of the device kernels that compute the nets' convolutions:
# the port's (csrc/conv3x3.cu) and cuDNN's, with its layout transforms.
_CONV_KERNELS = {"conv3x3 (K4/K5)": ("conv3x3_",),
                 "cuDNN conv": ("xmma", "cudnn", "implicit_gemm", "fprop",
                                "dgrad", "wgrad", "convolve", "nhwc", "nchw")}


def _conv_device_ms(device) -> str:
    out = []
    for group, keys in _CONV_KERNELS.items():
        hits = [e for e in device if any(k in e.name.lower() for k in keys)]
        ms = sum(e.time_range.end - e.time_range.start for e in hits) / 1e3
        out.append(f"{group} {ms:.3f} ms over {len(hits)} kernels")
    return ", ".join(out)


def profile_path(fused: str, conv_impl: str, card: str, batch: dict) -> None:
    from pde_control_tpu_torch.control.sequences import staggered_targets

    label = f"fused={fused} conv_impl={conv_impl}"
    app = chip_smoke.make_app("auto", fused=fused, conv_impl=conv_impl)
    for _ in range(2):
        app.progress(batch)
    tb = app.to_batch(batch)
    gt0, gtn = tb["obs"][:, 0], tb["obs"][:, -1]

    def op_tree():
        with torch.no_grad():
            staggered_targets(app._op, gt0, gtn, app.n)

    def forward():
        app.optimizer.zero_grad(set_to_none=True)
        app._loss_fn(tb)

    split = {
        "OP tree forward": _best_ms(op_tree),
        "forward with graph": _best_ms(forward),
        "forward + backward": _best_ms(lambda: app.compute_gradients(tb)),
    }
    app.compute_gradients(tb)
    split["Adam update"] = _best_ms(app.apply_gradients, reps=1)
    split["iteration"] = _best_ms(lambda: app.progress(batch))
    print(f"{label} phase split (ms, best of 3): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + f" [{card}]")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        app.progress(batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    launches = sum(e.name == "cudaLaunchKernel" for e in events)
    busy_ms = _busy_us(device) / 1e3
    print(f"{label} profiled iteration: wall {wall_ms:.3f} ms under the profiler, "
          f"{len(device)} device operations, {launches} cudaLaunchKernel calls, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of the "
          f"profiled wall time) [{card}]")
    print(f"{label} convolution device time: {_conv_device_ms(device)} [{card}]")
    table = prof.key_averages()
    print(table.table(sort_by="self_device_time_total", row_limit=12))
    print(table.table(sort_by="self_cpu_time_total", row_limit=12))


def main() -> None:
    card = chip_smoke.device_phase()
    batch = chip_smoke.make_batch()
    for fused, conv_impl in (("off", "xla"), ("cuda", "xla"), ("cuda", "cuda")):
        profile_path(fused, conv_impl, card, batch)


if __name__ == "__main__":
    main()
