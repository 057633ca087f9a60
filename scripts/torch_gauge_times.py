#!/usr/bin/env python3
"""Time the gauge grid's launches at the headline's series run, through
this tree's ``csrc/gauge_grid.cu`` and through other sources, on one card.

    python3 scripts/torch_gauge_times.py [--against FILE ...] [--turns N]

It runs the headline sweep (``chip_smoke.TWO_SERVERS_LB``, 2048 scenarios
of seed 0) streaming both servers' ready queues at 1 s, records that run's
gauge calls (a launch a group of sites: the entry hops, the LB's edges, a
visit's queue, the trailing IO and RAM, the exits), then replays every
call through each build in turns (this tree's, then each FILE, then back:
N rounds), each call bit-exact with its plain version and timed between
CUDA events (the median of five), and prints each call's ms and the sum a
chunk, with the card's name and power limit.  A FILE must keep this tree's
``GaugeGridArgs`` and launch interface.  It needs a CUDA card and imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_gauge_times: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from asyncflow_tpu_torch.engines.torchsim import _build, gauge_grid
    from asyncflow_tpu_torch.parallel import SweepRunner

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, nargs="*", default=[])
    parser.add_argument("--turns", type=int, default=2)
    args = parser.parse_args()
    builds = {"tree": _build.SOURCES["gauge_grid"][0]}
    builds.update({f"against{i}:{p.name}": p.resolve() for i, p in enumerate(args.against)})
    for name, path in builds.items():
        _build.SOURCES[f"gauge_times_{name}"] = (Path(path), ())
    _build.build([f"gauge_times_{name}" for name in builds])
    print(f"card: {chip_smoke.card_line()}", flush=True)

    def library(name: str):
        def load() -> ctypes.CDLL:
            lib = _build.load(f"gauge_times_{name}")
            lib.gauge_grid_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.gauge_grid_launch.restype = ctypes.c_int
            lib.gauge_grid_shared_rows.restype = ctypes.c_int
            lib.gauge_grid_shared_cells.restype = ctypes.c_int
            return lib
        return load

    runner = SweepRunner(chip_smoke.TWO_SERVERS_LB, device="cuda",
                         gauge_series=chip_smoke.GAUGE_SERIES)
    runner.run(chip_smoke.MAIN_SCENARIOS, seed=0)
    calls, kernel = chip_smoke._record_gauge_calls(runner.engine)
    runner.run(chip_smoke.MAIN_SCENARIOS, seed=0)
    runner.engine.gauge = kernel
    plain = gauge_grid.PlainGaugeGrid()
    wants = []
    for method, grid, call_args, kw in calls:
        want = grid.clone()
        getattr(plain, method)(want, *call_args, **kw)
        wants.append(want)
    order = list(builds)
    sums: dict = {name: [] for name in order}
    for turn in (order + order[::-1]) * args.turns:
        gauge_grid._library = library(turn)
        wrapper = gauge_grid.GaugeGrid()
        per = []
        for (method, grid, call_args, kw), want in zip(calls, wants, strict=True):
            got = grid.clone()
            getattr(wrapper, method)(got, *call_args, **kw)
            if not torch.equal(got, want):
                raise SystemExit(f"{turn}: {method} differs from its plain version")
            scratch = grid.clone()
            per.append(chip_smoke.time_kernel(
                torch, lambda m=method, a=call_args, k=kw: getattr(wrapper, m)(scratch, *a, **k),
                repeats=5))
        sums[turn].append(sum(per))
        print(f"{turn}: {sum(per):.4f} ms a chunk over {len(per)} launches: "
              + ", ".join(f"{c[0]} {ms:.4f}" for c, ms in zip(calls, per)), flush=True)
    print(json.dumps(sums))
    return 0


if __name__ == "__main__":
    sys.exit(main())
