#!/usr/bin/env python3
"""The port's scan fast path against the JAX fast path at a knee, on the
CPU: with the reference's window draws injected, and over several seeds
with each package's own draws.

    JAX_PLATFORMS=cpu python3 scripts/torch_seed_spread.py
        [--injected PATH ...] [--spread PATH] [--seeds 0-7]
        [--scenarios 2048] [--chunk 256]

``--injected`` (default overload_cap8 and db_pool_k2): seed 0's scenarios
of each ``chip_smoke.FAST_PAYLOADS`` path through the JAX ``FastEngine``
and the port's, the port fed the reference's per-window users and counts
(``tests/torch_fast_cases.reference_window_draws``, the tests'
matched-draws method).  Prints every counter's total on both sides, the
rejected fraction and the pooled p95, and whether every per-scenario
counter is equal.

``--spread`` (default overload_cap8): for each seed, each package's own
draws: the mean users a window (the JAX fast path's ``jax.random.poisson``
users; the port's ``lam_table`` users) and the rejected fraction; then
each package's mean rejected fraction over the seeds with its standard
error, the difference and the combined error.

Imports both packages: a CPU check, never run on the card.  Runs the
scenarios in chunks (``--chunk``) so that the CPU holds one chunk's lanes
at a time; each scenario's result is a function of its own key, so
chunking changes no number.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = ("n_generated", "lat_count", "n_dropped", "n_overflow", "n_rejected")


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _seeds(text: str) -> list[int]:
    if "-" in text:
        lo, hi = text.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in text.split(",")]


class Pair:
    """One path's plans and engines in both packages."""

    def __init__(self, data: dict) -> None:
        from asyncflow_tpu.compiler import compile_payload as jax_compile
        from asyncflow_tpu.engines.jaxsim.fastpath import FastEngine as JaxFastEngine
        from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
        from asyncflow_tpu_torch.compiler import compile_payload
        from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
        from asyncflow_tpu_torch.schemas import SimulationPayload

        self.ref_plan = jax_compile(JaxPayload.model_validate(data))
        self.plan = compile_payload(SimulationPayload.from_dict(data))
        if self.plan.n_generators != 1:
            msg = "torch_seed_spread takes single-generator paths"
            raise ValueError(msg)
        self.ref = JaxFastEngine(self.ref_plan)
        self.port = FastEngine(self.plan, device="cpu")

    def run(self, seed: int, n: int, chunk: int, *, injected: bool):
        """(reference totals, port totals, reference users, port users):
        per-scenario counters and pooled histograms of scenarios 0..n-1 of
        ``seed``, and each package's users of every window."""
        import jax
        import torch

        from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_keys
        from asyncflow_tpu_torch.engines.torchsim.kernel_engine import lam_table
        from torch_fast_cases import reference_window_draws

        keys = jax_keys(seed, n)
        ref_out, port_out = [], []
        ref_users, port_users = [], []
        for c0 in range(0, n, chunk):
            k = keys[c0 : c0 + chunk]
            windows = reference_window_draws(self.ref_plan, k)
            ref_out.append(jax.tree_util.tree_map(np.asarray, self.ref.run_batch(k)))
            port_out.append(self.port.run_batch(np.asarray(k),
                                                window_draws=windows if injected else None))
            ref_users.append(windows[0])
            kt = torch.as_tensor(np.asarray(k).astype(np.int64))
            port_users.append(lam_table(
                kt, float(self.plan.gen_user_mean[0]), 1.0,
                n_windows=int(self.port.stream_windows[0]),
                user_var=float(self.plan.gen_user_var[0])).numpy())
        return (_stack(ref_out), _stack(port_out), np.concatenate(ref_users),
                np.concatenate(port_users))


def _stack(states) -> dict:
    out = {f: np.concatenate([np.asarray(getattr(s, f)) for s in states]) for f in COUNTERS}
    out["hist"] = sum(np.asarray(s.hist).astype(np.int64).sum(axis=0) for s in states)
    return out


def _rejected(tot: dict) -> float:
    return int(tot["n_rejected"].sum()) / max(int(tot["n_generated"].sum()), 1)


def _p95(tot: dict) -> float:
    from asyncflow_tpu_torch.engines.results import hist_percentile
    from asyncflow_tpu_torch.engines.torchsim.params import hist_edges

    return float(hist_percentile(tot["hist"], hist_edges(), 95))


def injected(smoke, names: list[str], n: int, chunk: int) -> None:
    for name in names:
        t0 = time.perf_counter()
        ref, got, ref_users, _ = Pair(smoke.FAST_PAYLOADS[name]).run(0, n, chunk, injected=True)
        print(f"injected {name}: seed 0, scenarios 0..{n - 1}, reference window draws "
              f"(mean users {ref_users.mean()!r}), {time.perf_counter() - t0:.1f} s")
        equal = True
        for f in COUNTERS:
            same = np.array_equal(ref[f].astype(np.int64), got[f].astype(np.int64))
            equal &= same
            print(f"  {f}: jax {int(ref[f].sum())} port {int(got[f].sum())} "
                  f"per scenario {'equal' if same else 'DIFFER'}")
        print(f"  rejected_fraction jax {_rejected(ref)!r} port {_rejected(got)!r}")
        print(f"  p95_s jax {_p95(ref)!r} port {_p95(got)!r}")
        print(f"  hist equal {np.array_equal(ref['hist'], got['hist'])}; "
              f"every counter equal {equal}", flush=True)


def spread(smoke, name: str, seeds: list[int], n: int, chunk: int) -> None:
    pair = Pair(smoke.FAST_PAYLOADS[name])
    print(f"spread {name}: scenarios 0..{n - 1} a seed, each package's own draws")
    print("  seed | jax users | port users | jax rejected | port rejected")
    rows = []
    for seed in seeds:
        ref, got, ref_users, port_users = pair.run(seed, n, chunk, injected=False)
        row = (ref_users.mean(), port_users.mean(), _rejected(ref), _rejected(got))
        rows.append(row)
        print(f"  {seed} | {row[0]!r} | {row[1]!r} | {row[2]!r} | {row[3]!r}", flush=True)
    arr = np.asarray(rows, np.float64)
    k = len(seeds)
    mean = arr.mean(axis=0)
    se = arr.std(axis=0, ddof=1) / np.sqrt(k) if k > 1 else np.full(4, np.nan)
    labels = ("jax users", "port users", "jax rejected", "port rejected")
    for label, m, e in zip(labels, mean, se):
        print(f"  mean {label} {m!r} (SE {e!r})")
    diff = mean[3] - mean[2]
    comb = float(np.hypot(se[2], se[3]))
    print(f"  rejected: port - jax {diff!r}, combined SE {comb!r}, "
          f"{abs(diff) / comb if comb else float('nan'):.2f} SE")
    # the users' standard error a seed: Poisson, var = mean, over S x NW draws
    user_mean = float(pair.plan.gen_user_mean[0])
    draws = n * int(pair.port.stream_windows[0])
    print(f"  users' SE a seed {np.sqrt(user_mean / draws)!r} (Poisson({user_mean}), "
          f"{draws} draws)")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--injected", nargs="*", default=None, metavar="PATH")
    parser.add_argument("--spread", default=None, metavar="PATH")
    parser.add_argument("--seeds", default="0-7")
    parser.add_argument("--scenarios", type=int, default=2048)
    parser.add_argument("--chunk", type=int, default=256)
    args = parser.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    smoke = _smoke()
    both = args.injected is None and args.spread is None
    names = args.injected if args.injected else ["overload_cap8", "db_pool_k2"]
    if both or args.injected is not None:
        injected(smoke, names, args.scenarios, args.chunk)
    if both or args.spread is not None:
        spread(smoke, args.spread or "overload_cap8", _seeds(args.seeds), args.scenarios,
               args.chunk)
    return 0


if __name__ == "__main__":
    sys.exit(main())
