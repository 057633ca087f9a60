#!/usr/bin/env python3
"""Lane by lane, the port's edge hops and token bucket against the jitted
JAX reference's, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_jit_hop_parity.py PAYLOAD
        [--lanes N] [--window LO HI] [--tree DIR]

PAYLOAD is an example (``examples/yaml_input/data``), a mutation of
``tests/torch_fast_cases.py``, or ``bucket``.  For each edge of the payload
it draws N sorted send times a scenario (four scenarios) in [LO, HI)
seconds (the whole horizon by default), runs the jitted reference's
``FastEngine._edge_hop`` (the overrides traced, as ``run_batch`` traces
them) and adds the send time, runs the port's hop (``FastEngine._hop``) on
the same lanes and keys, and prints how many sent lanes' arrival times
differ.  ``bucket`` runs the reference's ``_token_bucket_scan`` jitted and
the port's ``token_bucket_plain`` on synthetic sorted rows at four (rate,
burst) pairs and prints how many accepted flags differ.  ``--tree DIR``
runs another checkout's port (a parent's, unpacked with ``git archive``),
so that two trees' counts can be set side by side.  It imports both
packages and runs on the CPU only.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def bucket_counts(jax, np, torch, station_scan, token_bucket_scan) -> tuple[int, int]:
    rng = np.random.default_rng(1)
    bad = total = 0
    for rate, burst in ((5.0, 50.0), (0.37, 3.0), (13.3, 7.0), (100.0, 1.0)):
        t = np.cumsum(rng.exponential(1.0 / (1.3 * rate + 1.0), (16, 4000)),
                      axis=1).astype(np.float32)
        v = rng.random((16, 4000)) < 0.8
        want = np.asarray(jax.jit(jax.vmap(
            lambda a, b, r=rate, c=burst: token_bucket_scan(a, b, r, c)))(t, v))
        got = station_scan.token_bucket_plain(torch.from_numpy(t), torch.from_numpy(v),
                                              rate, burst).numpy()
        bad += int((want != got).sum())
        total += want.size
    return bad, total


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("payload")
    parser.add_argument("--lanes", type=int, default=50_000)
    parser.add_argument("--window", type=float, nargs=2, default=None)
    parser.add_argument("--tree", type=Path, default=ROOT)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT / "tests"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(args.tree.resolve()))
    import jax
    import numpy as np
    import torch
    from torch_fast_cases import MUTATIONS, example, mutated, one_torch_thread

    from asyncflow_tpu.compiler import compile_payload as jax_compile
    from asyncflow_tpu.engines.jaxsim.engine import scenario_keys as jax_keys
    from asyncflow_tpu.engines.jaxsim.fastpath import FastEngine as JaxFastEngine
    from asyncflow_tpu.engines.jaxsim.fastpath import _token_bucket_scan
    from asyncflow_tpu.engines.jaxsim.params import base_overrides as jax_base
    from asyncflow_tpu.schemas.payload import SimulationPayload as JaxPayload
    from asyncflow_tpu_torch.compiler import compile_payload
    from asyncflow_tpu_torch.engines.torchsim import station_scan
    from asyncflow_tpu_torch.engines.torchsim.fastpath import FastEngine
    from asyncflow_tpu_torch.engines.torchsim.params import base_overrides
    from asyncflow_tpu_torch.schemas import SimulationPayload

    one_torch_thread()
    print(f"port: {sys.modules['asyncflow_tpu_torch'].__file__}")
    if args.payload == "bucket":
        bad, total = bucket_counts(jax, np, torch, station_scan, _token_bucket_scan)
        print(f"bucket: {bad} of {total} accepted flags differ from the jitted reference's")
        return 0
    data = mutated(args.payload) if args.payload in MUTATIONS else example(args.payload)
    ref_plan = jax_compile(JaxPayload.model_validate(data))
    ref_eng, jov = JaxFastEngine(ref_plan), jax_base(ref_plan)
    scenarios, n = 4, args.lanes
    keys = jax_keys(4, scenarios)
    lo, hi = args.window if args.window else (0.0, float(ref_plan.horizon))
    t = np.sort(np.random.default_rng(0).uniform(lo, hi, (scenarios, n)).astype(np.float32),
                axis=1)
    plan = compile_payload(SimulationPayload.from_dict(data))
    eng = FastEngine(plan, device="cpu")
    tables = eng._edge_tables(eng._overrides(base_overrides(plan), scenarios))
    kt = torch.as_tensor(np.asarray(keys).astype(np.int64))
    t_send = torch.from_numpy(t)
    alive = torch.ones_like(t_send, dtype=torch.bool)
    total = 0
    for edge in range(ref_plan.n_edges):
        def hop(k, x, ov, e=edge):
            _, delay = ref_eng._edge_hop(jax.random.fold_in(k, 16), e, x, ov)
            return x + delay

        want = np.asarray(jax.jit(jax.vmap(hop, in_axes=(0, 0, None)))(keys, t, jov))
        got = eng._hop(tables, kt, 16, t_send, alive, edge=edge)
        sent = got.ok.numpy() & (t < ref_plan.horizon)
        bad = int(((got.t_next.numpy() != want) & sent).sum())
        total += bad
        print(f"{args.payload} edge {edge} (law {int(ref_plan.edge_dist[edge])}): {bad} of "
              f"{int(sent.sum())} sent lanes' arrival times differ")
    print(f"{args.payload}: {total} in all, sends in [{lo}, {hi}) s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
