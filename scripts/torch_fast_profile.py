#!/usr/bin/env python3
"""Where the scan fast path's time goes on one CUDA card.

    python3 scripts/torch_fast_profile.py [PATH ...] [--scenarios N] [--series]
                                          [--tree DIR]

For each path (a key of ``chip_smoke.FAST_PAYLOADS``; all by default) it
runs ``SweepRunner(payload).run(N, seed=0)`` (with the path's sweep axes,
``chip_smoke.FAST_SWEEP_AXES``; with ``--series``, streaming
``chip_smoke.GAUGE_SERIES``, both servers' ready queues at 1 s, so that the
gauge grid's launches and the passes that feed them are traced) once to
warm up, then once
under ``torch.profiler`` with CPU and CUDA activities, and prints the
sweep's wall time, the device time summed over kernels, the device's idle
share of the wall (1 - device time / wall), the peak device memory of an
unprofiled run, the device time by kind of kernel (the port's three
kernels, float adds, clamps, selects, the other elementwise kernels,
sorts, gathers and scatters, copies) and by kernel name (the 20 largest),
with the card's name and power limit.  With ``--series`` it also prints
the gauge work a chunk: one chunk's ``run_tensors`` with the series' grid
and without it, between CUDA events, in turns (off, on, on, off, twice).
``--tree DIR`` runs another checkout's package and ``chip_smoke.py`` (a
parent's, unpacked with ``git archive``), so that two trees are compared
in one call.  It needs a CUDA card and imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: kinds of kernel, by a piece of the kernel's name (the first that matches)
KINDS = (
    ("edge_draws", ("uniform_kernel", "gap_sum_kernel", "hop_kernel", "hop_reduce_kernel",
                    "edge_draws_kernel", "EdgeDrawArgs")),
    ("station_scan", ("station_scan", "control_thread_kernel", "StationArgs")),
    ("lb_route", ("route_count_kernel", "route_marks_kernel", "lanes_kernel", "lc_kernel")),
    ("gauge_grid", ("gauge_shared_kernel", "gauge_global_kernel")),
    ("float adds", ("CUDAFunctor_add", "AddFunctor")),
    ("clamps", ("clamp",)),
    ("selects (where)", ("where",)),
    ("sorts", ("radix", "sort", "Sort")),
    ("gathers, scatters, indexing", ("gather", "scatter", "index", "Index")),
    ("copies", ("copy", "Memcpy", "Memset", "fill")),
    ("other elementwise", ("elementwise", "reduce_kernel")),
)


def kind_of(kernel: str) -> str:
    for kind, pieces in KINDS:
        if any(p in kernel for p in pieces):
            return kind
    return "other"


def gauge_work(torch, runner, chip_smoke) -> None:
    """The gauge work a chunk of ``runner``'s series sweep: its engine's
    ``run_tensors`` of one chunk against the same engine's without the
    grid, between CUDA events, medians over turns."""
    import copy

    import numpy as np

    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys

    on = runner.engine
    off = copy.copy(on)
    off._collect_gauge_grid = False
    off.gauge_series_stride = 0
    keys = scenario_keys(0, runner.default_chunk, device="cuda")
    times: dict = {"off": [], "on": []}
    for turn in ("off", "on", "on", "off") * 2:
        eng = on if turn == "on" else off
        times[turn].append(chip_smoke.time_kernel(torch, lambda e=eng: e.run_tensors(keys),
                                                  repeats=3))
    on_ms, off_ms = float(np.median(times["on"])), float(np.median(times["off"]))
    print(f"  gauge work a chunk of {runner.default_chunk}: {on_ms - off_ms:.3f} ms "
          f"(with the grid {on_ms:.3f} ms, without {off_ms:.3f} ms; turns {times})")


def profile_path(torch, name: str, scenarios: int, series: bool) -> None:
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from asyncflow_tpu_torch.parallel import SweepRunner, make_overrides

    runner = SweepRunner(chip_smoke.FAST_PAYLOADS[name], device="cuda",
                         **({"gauge_series": chip_smoke.GAUGE_SERIES} if series else {}))
    axes = chip_smoke.FAST_SWEEP_AXES.get(name)
    ov = make_overrides(runner.plan, scenarios, **axes(scenarios)) if axes else None
    runner.run(scenarios, seed=0, overrides=ov)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runner.run(scenarios, seed=0, overrides=ov)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run(scenarios, seed=0, overrides=ov)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel: dict[str, float] = defaultdict(float)
    calls: dict[str, int] = defaultdict(int)
    for event in prof.events():
        # events on the device are the kernels and copies themselves
        if event.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[event.name] += event.time_range.elapsed_us() / 1e3
            calls[event.name] += 1
    device_ms = sum(by_kernel.values())
    print(
        f"{name}: {scenarios} scenarios, engine {runner.engine_kind}, wall {wall_ms:.1f} ms, "
        f"device {device_ms:.1f} ms over {sum(calls.values())} kernels, idle share "
        f"{1.0 - device_ms / wall_ms:.3f}, peak device memory {peak_gb:.2f} GB",
    )
    by_kind: dict[str, float] = defaultdict(float)
    kind_calls: dict[str, int] = defaultdict(int)
    for kernel, ms in by_kernel.items():
        by_kind[kind_of(kernel)] += ms
        kind_calls[kind_of(kernel)] += calls[kernel]
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  kind {kind}: {ms:.3f} ms ({ms / device_ms:.1%}), {kind_calls[kind]} launches")
    for kernel, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {ms:9.3f} ms  {ms / device_ms:6.1%}  x{calls[kernel]:<4d} {kernel[:110]}")
    if series:
        gauge_work(torch, runner, chip_smoke)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_fast_profile: no CUDA device is available", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("paths", nargs="*")
    parser.add_argument("--scenarios", type=int, default=2048)
    parser.add_argument("--series", action="store_true",
                        help="stream both servers' ready queues at 1 s")
    parser.add_argument("--tree", type=Path, default=ROOT,
                        help="the checkout whose package and chip_smoke.py run")
    args = parser.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    import chip_smoke

    print(f"card: {chip_smoke.card_line()}; tree {args.tree}")
    for name in args.paths or list(chip_smoke.FAST_PAYLOADS):
        profile_path(torch, name, args.scenarios, args.series)
    return 0


if __name__ == "__main__":
    sys.exit(main())
