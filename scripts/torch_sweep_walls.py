#!/usr/bin/env python3
"""Wall time of the scan fast path's sweeps on one CUDA card, to compare
two checkouts of the port in one call.

    python3 scripts/torch_sweep_walls.py [PATH ...] [--tree DIR] [--repeats N]
                                         [--scenarios N]

Imports the port and ``chip_smoke.FAST_PAYLOADS`` from DIR (this checkout
by default; another commit's tree unpacked with ``git archive``), and for
each path (a key of ``FAST_PAYLOADS``; all by default) runs
``SweepRunner(payload).run(N, seed=0)`` (with the path's sweep axes,
``FAST_SWEEP_AXES``, where the tree has them) once to warm up, then ``--repeats``
times with no profiler, each run ending in ``torch.cuda.synchronize()``.
Prints the card's name and power limit, then a line a path: every wall in
ms, their median and quartiles, and the scenarios a second at the median.
Run it once a tree in turns (A, B, B, A) to compare two trees.  Needs a
CUDA card; imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("paths", nargs="*")
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--repeats", type=int, default=10)
    parser.add_argument("--scenarios", type=int, default=2048)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_sweep_walls: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import chip_smoke
    from asyncflow_tpu_torch.parallel import SweepRunner

    print(f"card: {chip_smoke.card_line()}; tree {args.tree}", flush=True)
    # a path's sweep axes, in a tree that has any
    axes_of = getattr(chip_smoke, "FAST_SWEEP_AXES", {})
    for name in args.paths or list(chip_smoke.FAST_PAYLOADS):
        runner = SweepRunner(chip_smoke.FAST_PAYLOADS[name], device="cuda")
        ov = None
        if name in axes_of:
            from asyncflow_tpu_torch.parallel import make_overrides

            ov = make_overrides(runner.plan, args.scenarios, **axes_of[name](args.scenarios))
        runner.run(args.scenarios, seed=0, overrides=ov)
        walls = []
        for _ in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.run(args.scenarios, seed=0, overrides=ov)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        q1, median, q3 = statistics.quantiles(walls, n=4)
        print(
            f"{name}: engine {runner.engine_kind}, walls ms "
            f"{' '.join(f'{w:.1f}' for w in walls)}; median {median:.1f}, quartiles "
            f"{q1:.1f} / {q3:.1f}; {args.scenarios / median * 1e3:.1f} scen/s at the median",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
