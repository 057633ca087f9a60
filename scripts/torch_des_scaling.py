#!/usr/bin/env python3
"""Time the PyTorch port's DES kernel on one path's plan at several scenario counts.

    python3 scripts/torch_des_scaling.py [PATH ...] [--counts 132,264,528,1056,2048,4096]

PATH is a key of ``chip_smoke.PAYLOADS`` (default: two_servers_lb).  The
kernel runs one scenario on one warp, so at 132 scenarios (one warp an SM
on an H100) the time per event is the latency of one scenario's chain of
events; where the time grows in step with the scenarios, the SMs' issue
rate bounds the kernel instead.  Prints the card's name and power limit,
then for each count the kernel's milliseconds (CUDA events around one
launch, after a warm-up launch), its events and the nanoseconds per event
per scenario.  Needs a CUDA card.  The plans, the card's line and the
timing are ``chip_smoke``'s (``PAYLOADS``, ``card_line``, ``time_kernel``),
so the times read as the smoke's phase 3 does.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("paths", nargs="*", default=["two_servers_lb"])
    parser.add_argument("--counts", default="132,264,528,1056,2048,4096")
    opts = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_des_scaling: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.engines.torchsim.kernel_engine import KernelEngine
    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
    from asyncflow_tpu_torch.schemas import SimulationPayload

    print(chip_smoke.card_line())
    for name in opts.paths:
        plan = compile_payload(SimulationPayload.from_dict(chip_smoke.PAYLOADS[name]))
        eng = KernelEngine(plan, device="cuda")
        eng.kernel(*eng.prepare(scenario_keys(0, 132, device="cuda")))  # build and warm up
        for s in (int(c) for c in opts.counts.split(",")):
            args = eng.prepare(scenario_keys(0, s, device="cuda"))
            out = []
            ms = chip_smoke.time_kernel(torch, lambda: out.append(eng.kernel(*args)), 1)
            per_scenario = int(out[0].n_events.sum()) / s
            print(
                f"{name} S={s}: kernel {ms:.1f} ms, {per_scenario:.0f} events a scenario, "
                f"{ms * 1e6 / per_scenario:.1f} ns an event a scenario",
                flush=True,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
