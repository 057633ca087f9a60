#!/usr/bin/env python3
"""Time builds of the port's station_scan kernel on one CUDA card.

    python3 scripts/torch_scan_variants.py [--rows 16] [--ahead 256] [--against SOURCE]
                                           [--row-counts 132,2048]
                                           [--paths NAME,...] [--no-synthetic]

Builds ``csrc/station_scan.cu`` once for each pair of rows a block of the
global walk (``-DSTATION_ROWS``) and prefetch distance in elements
(``-DSTATION_AHEAD``, 0 for none), and, with ``--against``, another
``station_scan.cu`` (say an earlier commit's, unpacked with ``git
archive``) as it is, one nvcc each, all at once.  Then it times each build
between CUDA events (``chip_smoke.time_kernel``, median of 5 launches after
a warm-up) at the fast paths' full-width shapes, on synthetic sorted
streams made on the card from a seed: the c = 1 wait scan over (2048,
87,840) (two_servers_lb), the RAM-core scan with 20 slots and one core over
(2048, 20,280) (single_server) and with 40 slots over (1797, 100,085)
(heavy_inj_single_server's chunk), and the Kiefer-Wolfowitz scan at K = 2
over (2048, 3,810) (db_pool_k2).  The builds take their turns in the order
given and then the reverse (A, B, B, A), each case on the same inputs, and
every build's outputs must equal the first build's bit for bit, but for the
c = 1 wait scan, whose order each source sets: there each build of this
tree must equal this tree's plain version (``lindley_plain``, the
reference's tree order) bit for bit, and the other source's lanes that
differ from it are printed (a source that walks Lindley in order).  With
``--row-counts``, each case is timed again on this source's last build
at those row counts (its rows' length kept): 132 rows is one warp an SM of the
warp walk, so the time an element a row there is the walk's chain, and at
more rows what the SM's pipes allow.  ``--paths`` names fast paths of
``chip_smoke.FAST_PAYLOADS`` (say rate_limited_lb, outage_retry,
overload_sockets, overload_cap8): each path's full-width sweep (2048
scenarios of seed 0, its sweep axes) runs once through the port's fast
engine, its first token bucket, socket and controlled scan calls are
recorded, and every build is timed on their arguments in the same turns,
its outputs held equal to the first build's and to the plain version's;
each line gives the call's valid share and the walk this tree's library
takes for it.
``--no-synthetic`` skips the synthetic cases.  Prints the card's name and
power limit and one line a build and case.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def streams(torch, s: int, m: int, rate: float, svc: float, seed: int) -> dict:
    """Sorted arrivals at ``rate`` a second, exponential services, about
    half the lanes valid (another station's), pre-IO 0 and post-IO of
    ~0.1 s, as (S, m) tensors on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.cumsum(torch.empty((s, m), device="cuda").exponential_(rate, generator=g), dim=1)
    d = torch.empty((s, m), device="cuda").exponential_(1.0 / svc, generator=g)
    v = torch.rand((s, m), device="cuda", generator=g) < 0.5
    post = 0.1 + torch.empty((s, m), device="cuda").exponential_(50.0, generator=g)
    return {"a": a, "d": d, "v": v, "pre": torch.zeros_like(a), "post": post}


def scratch_floats(lib, mode: int, cores: int, ram_k: int) -> int:
    """Floats of global scratch a row of ``lib``'s kernel needs: the
    global walk's carry (``station_scan_walk``), or an earlier build's
    ``station_scan_scratch_floats``."""
    from asyncflow_tpu_torch.engines.torchsim import station_scan

    if hasattr(lib, "station_scan_walk"):
        lib.station_scan_walk.argtypes = [ctypes.c_int] * 3
        if lib.station_scan_walk(mode, cores, ram_k) != station_scan.WALK_GLOBAL:
            return 0
        return cores + (ram_k if mode == station_scan.MODE_RAM_CORE else 0)
    lib.station_scan_scratch_floats.argtypes = [ctypes.c_int] * 3
    return lib.station_scan_scratch_floats(mode, cores, ram_k)


def launcher(torch, lib, mode: int, cores: int, ram_k: int, inputs: dict):
    """A function that launches ``lib``'s kernel on ``inputs`` and returns
    its outputs."""
    from asyncflow_tpu_torch.engines.torchsim import station_scan

    a = inputs["a"]
    outs = [torch.empty_like(a) for _ in range(3 if mode == station_scan.MODE_RAM_CORE else 1)]
    width = scratch_floats(lib, mode, cores, ram_k)
    scratch = torch.empty((a.shape[0], max(width, 1)), device="cuda")
    args = station_scan._StationArgs(
        a=a.data_ptr(), d=inputs["d"].data_ptr(), v=inputs["v"].data_ptr(),
        pre=inputs["pre"].data_ptr(), post=inputs["post"].data_ptr(),
        out0=outs[0].data_ptr(), out1=outs[-1 if len(outs) == 1 else 1].data_ptr(),
        out2=outs[-1].data_ptr(), scratch=scratch.data_ptr() if width else 0,
        S=a.shape[0], m=a.shape[1], mode=mode, cores=cores, ram_k=ram_k,
    )
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run():
        rc = lib.station_scan_launch(ctypes.byref(args), stream)
        if rc != 0:
            msg = f"station_scan launch failed: code {rc}"
            raise RuntimeError(msg)
        return outs

    return run


def recorded_launcher(torch, lib, kind: str, args: tuple):
    """A function that launches ``lib``'s kernel on a recorded token bucket
    (``kind`` "bucket"), socket or controlled scan call's arguments and
    returns its outputs."""
    from asyncflow_tpu_torch.engines.torchsim import station_scan

    if kind == "bucket":
        t, v, rate, burst = args
        outs = [torch.empty_like(v)]
        st = station_scan._StationArgs(a=t.data_ptr(), v=v.data_ptr(), flag=outs[0].data_ptr(),
                                       S=t.shape[0], m=t.shape[1], mode=station_scan.MODE_BUCKET,
                                       cores=1, rate=rate, burst=burst)
    elif kind == "controlled":
        e, d, v, cores, cap, timeout = args
        outs = [torch.empty_like(e), torch.empty(e.shape, dtype=torch.uint8, device=e.device)]
        st = station_scan._StationArgs(
            a=e.data_ptr(), d=d.data_ptr(), v=v.data_ptr(), out0=outs[0].data_ptr(),
            flag=outs[1].data_ptr(), S=e.shape[0], m=e.shape[1],
            mode=station_scan.MODE_CONTROLLED, cores=cores, cap=cap,
            timeout=float(torch.tensor(timeout, dtype=torch.float32)))
    else:
        a, e, d, post, b, v, cores, conn, cap, timeout = args
        outs = [torch.empty_like(a), torch.empty(a.shape, dtype=torch.uint8, device=a.device)]
        st = station_scan._StationArgs(
            a=a.data_ptr(), e=e.data_ptr(), d=d.data_ptr(), post=post.data_ptr(),
            b=b.data_ptr(), v=v.data_ptr(), out0=outs[0].data_ptr(), flag=outs[1].data_ptr(),
            S=a.shape[0], m=a.shape[1], mode=station_scan.MODE_SOCKET, cores=cores, conn=conn,
            cap=cap, timeout=float(torch.tensor(timeout, dtype=torch.float32)))
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run():
        rc = lib.station_scan_launch(ctypes.byref(st), stream)
        if rc != 0:
            msg = f"station_scan launch failed: code {rc}"
            raise RuntimeError(msg)
        return outs

    return run


def path_calls(torch, name: str) -> list:
    """(kind, args) of the first token bucket, socket and controlled scan
    calls of the fast path ``name``'s full-width run, as chip_smoke's phase
    5 records them."""
    import chip_smoke
    from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
    from asyncflow_tpu_torch.parallel import SweepRunner

    eng = SweepRunner(chip_smoke.FAST_PAYLOADS[name], device="cuda").engine
    n = chip_smoke.MAIN_SCENARIOS
    keys = scenario_keys(0, n, device="cuda")
    wrappers = chip_smoke._wrappers(eng)
    calls = chip_smoke._record_kernel_calls(eng, every=False)
    eng.run_tensors(keys, chip_smoke.path_overrides(name, eng.plan, n))
    chip_smoke._set_wrappers(eng, wrappers)
    return [(kind, args) for kind, args, _ in calls
            if kind in ("bucket", "socket", "controlled")]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", default="16")
    parser.add_argument("--ahead", default="256")
    parser.add_argument("--against", default=None,
                        help="another station_scan.cu to build and time beside this one")
    parser.add_argument("--row-counts", default="",
                        help="row counts to time each case at on this source's build")
    parser.add_argument("--paths", default="",
                        help="fast paths whose recorded bucket and socket calls to time")
    parser.add_argument("--no-synthetic", action="store_true",
                        help="skip the synthetic cases")
    opts = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_scan_variants: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from asyncflow_tpu_torch.engines.torchsim import _build, station_scan

    print(chip_smoke.card_line())
    src = _build.SOURCES["station_scan"][0]
    names = []
    if opts.against:
        _build.SOURCES["station_scan_against"] = (Path(opts.against).resolve(), ())
        names.append("station_scan_against")
    for rows in (int(r) for r in opts.rows.split(",")):
        for ahead in (int(x) for x in opts.ahead.split(",")):
            name = f"station_scan_rows{rows}_ahead{ahead}"
            _build.SOURCES[name] = (src, (f"-DSTATION_ROWS={rows}", f"-DSTATION_AHEAD={ahead}"))
            names.append(name)
    t0 = time.perf_counter()
    # with --paths, the fast engine's own libraries besides, all at once
    _build.build(None if opts.paths else names)
    print(f"built {len(names)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    libs = {}
    for name in names:
        for line in _build.ptxas_report.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas[{name}] {line.split(':', 2)[-1].strip()}")
        lib = _build.load(name)
        lib.station_scan_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        libs[name] = lib
    cases = {
        "waits c=1 (2048 x 87840)": (station_scan.MODE_LINDLEY, 1, 0,
                                     (2048, 87_840, 133.0, 0.002, 0)),
        "ram_core k=20 c=1 (2048 x 20280)": (station_scan.MODE_RAM_CORE, 1, 20,
                                             (2048, 20_280, 40.0, 0.001, 1)),
        "ram_core k=40 c=1 (1797 x 100085)": (station_scan.MODE_RAM_CORE, 1, 40,
                                              (1797, 100_085, 150.0, 0.001, 2)),
        "kw K=2 (2048 x 3810)": (station_scan.MODE_KW, 2, 0, (2048, 3_810, 40.0, 0.06, 3)),
    }
    order = names + names[::-1]
    plain = station_scan.PlainStationScan()
    for path in (p for p in opts.paths.split(",") if p):
        for kind, args in path_calls(torch, path):
            valid = args[{"bucket": 1, "controlled": 2}.get(kind, 5)]
            mode = {"bucket": station_scan.MODE_BUCKET, "controlled": station_scan.MODE_CONTROLLED,
                    "socket": station_scan.MODE_SOCKET}[kind]
            shape = (1, 0, -1) if kind == "bucket" else (
                (args[3], 0, args[4]) if kind == "controlled" else (args[6], args[7], args[8]))
            walk = station_scan.WALK_NAMES[station_scan.walk_of(mode, *shape)]
            case = (f"{path} {kind} ({valid.shape[0]} x {valid.shape[1]}, valid share "
                    f"{float(valid.float().mean()):.4f}, this tree's {walk} walk)")
            want = getattr(plain, kind)(*args)
            want = list(want) if isinstance(want, tuple) else [want]
            for name in order:
                run = recorded_launcher(torch, libs[name], kind, args)
                out = run()
                if not all(torch.equal(x, y) for x, y in zip(out, want, strict=True)):
                    print(f"{case}: {name} differs from the plain version", file=sys.stderr)
                    return 1
                ms = chip_smoke.time_kernel(torch, run, repeats=5)
                print(f"{case}: {name} {ms:.4f} ms", flush=True)
    if opts.no_synthetic:
        return 0
    for case, (mode, cores, ram_k, shape) in cases.items():
        inputs = streams(torch, *shape)
        lindley = mode == station_scan.MODE_LINDLEY
        first = ([station_scan.lindley_plain(inputs["a"], inputs["d"], inputs["v"])]
                 if lindley else None)
        for name in order:
            run = launcher(torch, libs[name], mode, cores, ram_k, inputs)
            out = [x.clone() for x in run()]
            note = ""
            if first is None:
                first = out
            elif lindley and name == "station_scan_against":
                off = int((out[0].view(torch.int32) != first[0].view(torch.int32)).sum())
                note = f"; {off} of {out[0].numel()} lanes differ from the tree order"
            elif not all(torch.equal(x, y) for x, y in zip(out, first, strict=True)):
                what = "the plain version" if lindley else order[0]
                print(f"{case}: {name} differs from {what}", file=sys.stderr)
                return 1
            ms = chip_smoke.time_kernel(torch, run, repeats=5)
            print(f"{case}: {name} {ms:.3f} ms{note}", flush=True)
            del out
        del inputs, first
        for rows in (int(r) for r in opts.row_counts.split(",") if r):
            inputs = streams(torch, rows, *shape[1:])
            run = launcher(torch, libs[names[-1]], mode, cores, ram_k, inputs)
            run()
            ms = chip_smoke.time_kernel(torch, run, repeats=5)
            print(f"{case} at {rows} rows: {names[-1]} {ms:.3f} ms, "
                  f"{ms * 1e6 / shape[1]:.1f} ns an element a row", flush=True)
            del inputs
    return 0


if __name__ == "__main__":
    sys.exit(main())
