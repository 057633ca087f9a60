#!/usr/bin/env python3
"""Time the blame grid's launch at the headline's planes run, through this
tree's ``csrc/blame_grid.cu`` and through other sources, on one card.

    python3 scripts/torch_blame_times.py [--against FILE ...] [--turns N]

It runs the headline sweep (``chip_smoke.TWO_SERVERS_LB``, 2048 scenarios
of seed 0, one chunk) with ``blame=True``, records that run's
``blame_grid`` call (every credit of the chunk's lanes, their coarse bins
and latencies), then replays it through each build in turns (this tree's,
then each FILE, then back: N rounds), each launch timed between CUDA
events (the median of five), and prints each build's registers and spills,
its ms, whether two of
its launches give the same bits, whether its grid equals this tree's bit
for bit, and its cells one float32 ulp from the plain version's sums
(none may be further), with the card's name and power limit.  A FILE must keep this tree's ``BlameGridArgs`` and launch
interface.  It needs a CUDA card and imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_blame_times: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from asyncflow_tpu_torch.engines.torchsim import _build, blame_grid
    from asyncflow_tpu_torch.parallel import SweepRunner

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, nargs="*", default=[])
    parser.add_argument("--turns", type=int, default=2)
    args = parser.parse_args()
    builds = {"tree": _build.SOURCES["blame_grid"][0]}
    builds.update({f"against{i}:{p.name}": p.resolve() for i, p in enumerate(args.against)})
    for name, path in builds.items():
        _build.SOURCES[f"blame_times_{name}"] = (Path(path), ())
    _build.build([f"blame_times_{name}" for name in builds])
    print(f"card: {chip_smoke.card_line()}", flush=True)
    for name in builds:
        used = [line.split("ptxas info    : ")[-1] for line in
                _build.ptxas_report[f"blame_times_{name}"].splitlines()
                if "registers" in line or "spill" in line]
        print(f"{name} ptxas: " + "; ".join(used), flush=True)
    load = blame_grid._build.load

    runner = SweepRunner(chip_smoke.TWO_SERVERS_LB, device="cuda", blame=True)
    runner.run(chip_smoke.MAIN_SCENARIOS, seed=0)
    calls, kernel = chip_smoke._record_blame_calls(runner.engine)
    runner.run(chip_smoke.MAIN_SCENARIOS, seed=0)
    runner.engine.blame_grid = kernel
    call = calls[0]
    want = blame_grid.blame_grid_plain(*call)
    order = list(builds)
    times: dict = {name: [] for name in order}
    notes: dict = {}
    first: dict = {}
    for turn in (order + order[::-1]) * args.turns:
        blame_grid._build.load = lambda _name, t=turn: load(f"blame_times_{t}")
        wrapper = blame_grid.BlameGrid()
        got = wrapper.reduce(*call)
        again = wrapper.reduce(*call)
        off = 0
        for g, w in zip(got, want, strict=True):
            ulps = (g.view(torch.int32).long() - w.view(torch.int32).long()).abs()
            if int(ulps.max()) > 1:
                print(f"torch_blame_times: {turn} is {int(ulps.max())} ulps from the plain "
                      "version", file=sys.stderr)
                return 1
            off += int((ulps > 0).sum())
        same = all(torch.equal(x, y) for x, y in zip(got, again, strict=True))
        if not same:
            print(f"torch_blame_times: {turn}'s two launches differ", file=sys.stderr)
            return 1
        first.setdefault(turn, got)
        notes[turn] = off
        times[turn].append(chip_smoke.time_kernel(torch, lambda w=wrapper: w.reduce(*call), 5))
    blame_grid._build.load = load
    credits, target = call[0], call[1]
    print(f"the headline's call: {len(credits)} credits and the latencies over "
          f"{target.shape[0]} x {target.shape[1]} lanes, {call[3]} cells x {call[4]} bins",
          flush=True)
    for name in order:
        equal = all(torch.equal(x, y) for x, y in zip(first[name], first[order[0]], strict=True))
        print(f"{name}: " + ", ".join(f"{ms:.3f}" for ms in times[name]) + " ms; two launches "
              f"bit-identical; {'equal' if equal else 'not equal'} to {order[0]}'s bits; "
              f"{notes[name]} cells one ulp from the plain sums", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
