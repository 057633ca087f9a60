#!/usr/bin/env python3
"""Time one checkout's gap prefix sum on one CUDA card.

    python3 scripts/torch_gap_sum_times.py [--tree DIR] [--paths NAME,...] [--repeats 5]

For each fast path (a key of ``chip_smoke.FAST_PAYLOADS``; by default
two_servers_lb, heavy_inj_single_server and chaos_campaign) it takes the
shape of the path's first arrival stream (the sweep's default chunk of
scenarios by its stream's lanes) and the keys the fast path gives it at
seed 0, and times between CUDA events (``chip_smoke.time_kernel``, median
of ``--repeats`` after a warm-up), in the port of ``--tree`` (a checkout,
say an earlier commit unpacked with ``git archive``; this one by default):
the ``EdgeDraws.gap_cumsum`` call alone, the prefix the fast path
builds from it, a leading zero and the sums (a checkout whose call
returns the sums alone is timed with the fast path's copy of them behind
a zero column), and the same gaps drawn without their sum
(``EdgeDraws.uniform(keys, n, gap=True)``: the draw's own time), with
the edge_draws launches of one call.  Each line ends with a checksum of
the prefix's bits, which two checkouts' runs must share.  Run it on two
checkouts in turns in one chip call (old, new, new, old) to compare them.
Prints the card's name and power limit first.  Needs a CUDA card;
imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATHS = "two_servers_lb,heavy_inj_single_server,chaos_campaign"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(ROOT), help="the checkout whose port to time")
    parser.add_argument("--paths", default=PATHS)
    parser.add_argument("--repeats", type=int, default=5)
    opts = parser.parse_args()
    tree = Path(opts.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_gap_sum_times: no CUDA device is available", file=sys.stderr)
        return 2
    # this checkout's chip_smoke (its payloads and timer), the port of --tree
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from asyncflow_tpu_torch.engines.torchsim.draws import EdgeDraws
    from asyncflow_tpu_torch.engines.torchsim.keys import fold_in, scenario_keys
    from asyncflow_tpu_torch.parallel import SweepRunner

    import asyncflow_tpu_torch

    print(smoke.card_line())
    print(f"tree {tree} (package {Path(asyncflow_tpu_torch.__file__).parent})", flush=True)
    draws = EdgeDraws()
    for name in (p for p in opts.paths.split(",") if p):
        runner = SweepRunner(smoke.FAST_PAYLOADS[name], device="cuda")
        s = min(runner.default_chunk, smoke.MAIN_SCENARIOS)
        n = int(runner.engine.gen_n[0])
        # the first stream's gap keys: fold_in(k_arr, 3), k_arr = fold_in(key, 0)
        keys = fold_in(fold_in(scenario_keys(0, s, device="cuda"), 0), 3)

        def prefix():
            out = draws.gap_cumsum(keys, n)
            if out.shape[1] == n:
                out = torch.cat([out.new_zeros((s, 1)), out], dim=1)
            return out

        before = draws.launches
        out = prefix()
        launches = draws.launches - before
        checksum = int(out.view(torch.int32).to(torch.int64).sum())
        del out
        call_ms = smoke.time_kernel(torch, lambda: draws.gap_cumsum(keys, n), opts.repeats)
        prefix_ms = smoke.time_kernel(torch, prefix, opts.repeats)
        draw_ms = smoke.time_kernel(torch, lambda: draws.uniform(keys, n, gap=True),
                                    opts.repeats)
        print(f"{name} ({s} x {n}): gap_cumsum {call_ms:.4f} ms, the prefix {prefix_ms:.4f} "
              f"ms, the gaps alone {draw_ms:.4f} ms, {launches} edge_draws launches a call; "
              f"checksum {checksum}", flush=True)
        del runner, keys
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
