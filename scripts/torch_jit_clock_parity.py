#!/usr/bin/env python3
"""Each request's clocks and the latency histogram of the port's fast path
against the jitted JAX reference's, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_jit_clock_parity.py PAYLOAD [PAYLOAD ...]
        [--scenarios 4] [--horizon 60] [--seed 0] [--tree DIR]

PAYLOAD is an example (``examples/yaml_input/data``) or a mutation of
``tests/torch_fast_cases.py``, cut to ``--horizon`` seconds.  Both engines
run with ``collect_clocks`` (the reference's ``FastEngine.run_batch``, which
jits its program; the port's fed the reference's window draws), and it
prints how many completed requests' (arrival, completion) rows differ in
any bit, of how many, and how many histogram bins differ.  ``--tree DIR``
runs another checkout's port (a parent's, unpacked with ``git archive``),
so that two trees' counts can be set side by side.  It imports both
packages and runs on the CPU only.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("payloads", nargs="+")
    parser.add_argument("--scenarios", type=int, default=4)
    parser.add_argument("--horizon", type=float, default=60.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tree", type=Path, default=ROOT)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT / "tests"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(args.tree.resolve()))
    import numpy as np
    from torch_fast_cases import MUTATIONS, clock_runs, clocks_off, example, mutated

    import asyncflow_tpu_torch

    print(f"port: {Path(asyncflow_tpu_torch.__file__).parent}")
    for name in args.payloads:
        data = (mutated(name, horizon=args.horizon) if name in MUTATIONS
                else example(name, horizon=args.horizon))
        ref, got = clock_runs(data, args.scenarios, args.seed)
        bins = int((np.asarray(got.hist) != np.asarray(ref.hist)).sum())
        print(f"{name}: {clocks_off(ref, got)} of {int(np.asarray(ref.clock_n).sum())} "
              f"requests' clocks differ; {bins} histogram bins differ", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
