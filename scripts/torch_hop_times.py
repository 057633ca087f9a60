#!/usr/bin/env python3
"""Time one checkout's edge draws on one CUDA card, at each path's own calls.

    python3 scripts/torch_hop_times.py [--tree DIR] [--source FILE] [--against FILE ...]
                                       [--paths NAME,...] [--repeats 5] [--outputs-may-differ]

For each fast path (a key of ``chip_smoke.FAST_PAYLOADS``; by default
event_inj_lb, lc_mixed_fleet, heavy_inj_single_server, two_servers_lb,
single_server and chaos_campaign) it runs the fast engine of ``--tree``'s
port (a checkout, say an earlier commit unpacked with ``git archive``;
this one by default) once over ``chip_smoke.MAIN_SCENARIOS`` scenarios of
seed 0 with the path's own overrides (``chip_smoke.path_overrides``),
keeps the first ``EdgeDraws`` call of each kind (a uniform, a gap draw,
each kind of hop: static, LB by rank or by slot, with spikes, under fault
tables) and least connections' candidates (one ``EdgeDraws.candidates``
call, or in a checkout without it the slots' hops without sums, all of
them), and times each between CUDA events (``chip_smoke.time_kernel``,
median of ``--repeats``):

- as the path called it;
- on rows padded with dead lanes (``alive`` false) to the next multiple of
  16 lanes, every other input the same (its outputs' first lanes must
  equal the call's);
- where the call has spikes, without them.

With ``--source``, the tree's ``edge_draws`` library is built from that
file instead (say a variant of ``csrc/edge_draws.cu`` with a part taken
out, to see what the part costs); ``--paths ""`` only builds.

With ``--against`` (one or more other ``edge_draws.cu`` sources, say the
parent commit's), each call is instead timed in one process through the
tree's library and each other build in alternation, a launch of each a
round in turn (the order reversed every other round), so that the card's
drift reaches every build alike; a build that refuses a call's arguments
(an older source without its mode) shows "refused".  Every build must
give the same outputs, unless ``--outputs-may-differ`` (a change of the
draws' arithmetic), which prints each build's checksum that differs.

Each line gives the milliseconds and the picoseconds a lane (rows x
lanes a row; the candidates also a lane and slot), the edge_draws
launches of one call, and a checksum of the outputs' bytes, which two
checkouts' runs must share.  Without ``--against``, run it on two
checkouts in turns in one chip call (old, new, new, old) to compare
them.  Prints the card's name and power limit first.  Needs a CUDA card;
imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PATHS = ("event_inj_lb,lc_mixed_fleet,heavy_inj_single_server,two_servers_lb,single_server,"
         "chaos_campaign")
ROW_ALIGN = 16
#: the wrapper methods whose calls are kept
KEPT = ("uniform", "hop", "candidates")


class _Recorder:
    """Stands in for the engine's ``EdgeDraws``: passes every call on and
    keeps the first call of each kind (every candidates call of the first
    least-connections route: its slots' hops in an older checkout)."""

    def __init__(self, inner, slots: int, hop_kind) -> None:
        self.inner = inner
        self.slots = slots
        self.hop_kind = hop_kind
        self.calls: dict = {}

    def _kind(self, method: str, args: tuple, kw: dict) -> str:
        if method == "uniform":
            return "gap" if kw.get("gap") else "uniform"
        # an older checkout's candidates: hops without sums
        lanes = "candidates" if method == "candidates" or kw.get("sums") is False else None
        return self.hop_kind(args[0], kw, lanes)

    def __getattr__(self, name: str):
        fn = getattr(self.inner, name)
        if name not in KEPT:
            return fn

        def call(*args, **kw):
            kind = self._kind(name, args, kw)
            group = self.calls.setdefault(kind, [])
            room = self.slots if kind.startswith("candidates") and name == "hop" else 1
            if len(group) < room:
                group.append((name, args, kw))
            return fn(*args, **kw)

        return call


def _outputs(out) -> list:
    items = out if isinstance(out, tuple) else (out,)
    return [x for x in items if x is not None]


def _checksum(torch, outs: list) -> int:
    return sum(int(x.contiguous().view(torch.uint8).sum(dtype=torch.int64)) for x in outs)


def _padded(torch, args: tuple, kw: dict, s: int, n: int) -> tuple:
    """The call's (S, n) lane inputs padded to a multiple of ROW_ALIGN lanes:
    dead lanes (alive false), zeros elsewhere."""
    width = -(-n // ROW_ALIGN) * ROW_ALIGN

    def pad(x):
        if not isinstance(x, torch.Tensor) or x.ndim != 2 or tuple(x.shape) != (s, n):
            return x
        out = x.new_zeros((s, width))
        out[:, :n] = x
        return out

    return tuple(pad(a) for a in args), {k: pad(v) for k, v in kw.items()}, width


def _other_builds(build, draws, sources: list[str]) -> list:
    """(label, library) of each ``--against`` source, a library of its own
    beside the tree's ``edge_draws`` (built with the tree's kernels)."""
    out = []
    for i, src in enumerate(sources):
        lib = build.load(f"edge_draws_against{i}")
        lib.edge_draws_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.edge_draws_launch.restype = ctypes.c_int
        lib.edge_draws_args_size.restype = ctypes.c_int
        if lib.edge_draws_args_size() != ctypes.sizeof(draws._EdgeDrawArgs):
            msg = f"{src}: its EdgeDrawArgs differ from the tree's"
            raise SystemExit(msg)
        out.append((src, lib))
    return out


def _time_builds(torch, smoke, build, builds: list, run, repeats: int) -> list:
    """Each build's median ms of ``run()`` (None where it refuses the
    call), timed in alternation, and its outputs' checksum."""
    from asyncflow_tpu_torch.errors import KernelLaunchError

    sums, ok = [], []
    for _, lib in builds:
        build._loaded["edge_draws"] = lib
        try:
            sums.append(_checksum(torch, run()))
            ok.append(True)
        except KernelLaunchError:
            sums.append(None)
            ok.append(False)
    times: list[list[float]] = [[] for _ in builds]
    order = list(range(len(builds)))
    for r in range(repeats):
        for i in (order if r % 2 == 0 else order[::-1]):
            if ok[i]:
                build._loaded["edge_draws"] = builds[i][1]
                times[i].append(smoke.time_kernel(torch, run, 1))
    build._loaded["edge_draws"] = builds[0][1]
    return [(sorted(t)[len(t) // 2] if t else None, c) for t, c in zip(times, sums, strict=True)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(ROOT), help="the checkout whose port to time")
    parser.add_argument("--source", help="an edge_draws.cu to build in place of the tree's")
    parser.add_argument("--against", nargs="+", default=[],
                        help="other edge_draws.cu sources to time in alternation with it")
    parser.add_argument("--paths", default=PATHS)
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--outputs-may-differ", action="store_true",
                        help="time the --against builds even where their outputs differ")
    opts = parser.parse_args()
    tree = Path(opts.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_hop_times: no CUDA device is available", file=sys.stderr)
        return 2
    # this checkout's chip_smoke (its payloads, overrides and timer), the
    # port of --tree
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from asyncflow_tpu_torch.engines.torchsim import _build
    from asyncflow_tpu_torch.engines.torchsim import draws as draws_mod
    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys

    import asyncflow_tpu_torch

    print(smoke.card_line())
    print(f"tree {tree} (package {Path(asyncflow_tpu_torch.__file__).parent})"
          + (f", edge_draws built from {opts.source}" if opts.source else ""), flush=True)
    if opts.source:
        _build.SOURCES["edge_draws"] = (Path(opts.source).resolve(),
                                        _build.SOURCES["edge_draws"][1])
    # the fast path's kernels and the other sources, one nvcc each, at once
    for i, src in enumerate(opts.against):
        _build.SOURCES[f"edge_draws_against{i}"] = (Path(src).resolve(),
                                                    _build.SOURCES["edge_draws"][1])
    _build.build(["edge_draws", "station_scan", "lb_route",
                  *(f"edge_draws_against{i}" for i in range(len(opts.against)))])
    builds = [("tree", _build.load("edge_draws"))]
    if opts.against:
        builds += _other_builds(_build, draws_mod, opts.against)
        print("builds in alternation: " + ", ".join(label for label, _ in builds), flush=True)
    s = smoke.MAIN_SCENARIOS
    keys = scenario_keys(0, s, device="cuda")
    for name in (p for p in opts.paths.split(",") if p):
        eng = smoke._fast_engine(torch, smoke.FAST_PAYLOADS[name])
        draws = eng.draws
        rec = _Recorder(draws, int(eng.plan.n_lb_edges), smoke._hop_kind)
        eng.draws = rec
        eng.run_tensors(keys, smoke.path_overrides(name, eng.plan, s))
        eng.draws = draws
        for kind, group in sorted(rec.calls.items()):
            def run(calls=group):
                outs = []
                for method, args, kw in calls:
                    outs += _outputs(getattr(draws, method)(*args, **kw))
                return outs

            uniform = group[0][0] == "uniform"
            n = int(group[0][1][1]) if uniform else int(group[0][1][1].shape[1])
            slots = (len(group) if group[0][0] == "hop"
                     else int(group[0][1][3].shape[1]) if kind.startswith("candidates") else 1)
            lanes = s * n
            head = (f"{name} {kind} ({s} x {n}, {n % ROW_ALIGN} mod {ROW_ALIGN}"
                    + (f", {slots} slots" if kind.startswith("candidates") else "") + ")")
            before = draws.launches
            outs = run()
            launches = draws.launches - before
            checksum = _checksum(torch, outs)
            del outs
            if opts.against:
                got = _time_builds(torch, smoke, _build, builds, run, opts.repeats)
                parts = []
                for (label, _), (ms, c) in zip(builds, got, strict=True):
                    if ms is None:
                        parts.append(f"{label}: refused")
                        continue
                    if c != checksum and not opts.outputs_may_differ:
                        print(f"torch_hop_times: {name} {kind}: {label}'s outputs differ",
                              file=sys.stderr)
                        return 1
                    parts.append(f"{label}: {ms:.4f} ms, {ms * 1e9 / lanes:.2f} ps a lane"
                                 + (f" (outputs differ: checksum {c})" if c != checksum else ""))
                print(f"{head}: " + "; ".join(parts)
                      + f"; {launches} launches a call; checksum {checksum}", flush=True)
                continue
            ms = smoke.time_kernel(torch, run, opts.repeats)
            text = (f"{head}: {ms:.4f} ms, {ms * 1e9 / lanes:.2f} ps a lane"
                    + (f" ({ms * 1e9 / (lanes * slots):.2f} a lane and slot)"
                       if kind.startswith("candidates") else ""))
            if not uniform:
                # the padded calls' inputs, made once, outside the timing
                padded_calls = [(method, *_padded(torch, args, kw, s, n)[:2])
                                for method, args, kw in group]
                width = -(-n // ROW_ALIGN) * ROW_ALIGN
                outs, padded = run(), run(calls=padded_calls)
                for x, y in zip(outs, padded, strict=True):
                    if x.ndim >= 2 and x.shape[1] == n:
                        y = y[:, :n]
                    if not torch.equal(x, y):
                        print(f"torch_hop_times: {name} {kind}: the padded call's outputs "
                              "differ", file=sys.stderr)
                        return 1
                del outs, padded
                pad_ms = smoke.time_kernel(torch, lambda: run(calls=padded_calls), opts.repeats)
                del padded_calls
                text += (f"; padded to {width}: {pad_ms:.4f} ms, {pad_ms * 1e9 / lanes:.2f} ps "
                         "a lane")
                if group[0][1][0].spike_t is not None:
                    bare = [(method, (args[0]._replace(spike_t=None, spike_v=None), *args[1:]),
                             kw) for method, args, kw in group]
                    nb = int(group[0][1][0].spike_t.shape[0])
                    run(calls=bare)
                    bare_ms = smoke.time_kernel(torch, lambda: run(calls=bare), opts.repeats)
                    text += (f"; without its {nb} spike breakpoints: {bare_ms:.4f} ms, "
                             f"{bare_ms * 1e9 / lanes:.2f} ps a lane")
            print(f"{text}; {launches} launches a call; checksum {checksum}", flush=True)
        del eng, rec, draws
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
