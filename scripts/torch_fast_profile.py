#!/usr/bin/env python3
"""Where the scan fast path's time goes on one CUDA card.

    python3 scripts/torch_fast_profile.py [PATH ...] [--scenarios N]

For each path (a key of ``chip_smoke.FAST_PAYLOADS``; all by default) it
runs ``SweepRunner(payload).run(N, seed=0)`` once to warm up, then once
under ``torch.profiler`` with CPU and CUDA activities, and prints the
sweep's wall time, the device time summed over kernels, the device's idle
share of the wall (1 - device time / wall), and the device time by
kernel name (the 20 largest), with the card's name and power limit.  It
needs a CUDA card and imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def profile_path(torch, name: str, scenarios: int) -> None:
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from asyncflow_tpu_torch.parallel import SweepRunner

    runner = SweepRunner(chip_smoke.FAST_PAYLOADS[name], device="cuda")
    runner.run(scenarios, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run(scenarios, seed=0)
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
        f"{1.0 - device_ms / wall_ms:.3f}",
    )
    for kernel, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {ms:9.3f} ms  {ms / device_ms:6.1%}  x{calls[kernel]:<4d} {kernel[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_fast_profile: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("paths", nargs="*", default=list(chip_smoke.FAST_PAYLOADS))
    parser.add_argument("--scenarios", type=int, default=chip_smoke.MAIN_SCENARIOS)
    args = parser.parse_args()
    print(f"card: {chip_smoke.card_line()}")
    for name in args.paths:
        profile_path(torch, name, args.scenarios)
    return 0


if __name__ == "__main__":
    sys.exit(main())
