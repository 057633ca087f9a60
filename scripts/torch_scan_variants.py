#!/usr/bin/env python3
"""Time build variants of the port's station_scan kernel on one CUDA card.

    python3 scripts/torch_scan_variants.py [--rows 16,32] [--ahead 0,256]

Builds ``csrc/station_scan.cu`` once for each pair of rows a block
(``-DSTATION_ROWS``) and prefetch distance in elements
(``-DSTATION_AHEAD``, 0 for none), one nvcc each, all at once; then times
each build between CUDA events (``chip_smoke.time_kernel``, median of 5
launches after a warm-up) in the two modes the fast paths launch, at their
full-width shapes: the c = 1 wait scan over (2048, 87,840) and the RAM-core
scan with 20 slots and one core over (2048, 20,280), on synthetic sorted
streams made on the card from a seed.  Every build's outputs must equal
the first build's bit for bit.  Prints the card's name and power limit and
one line a build and mode.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
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


def launcher(torch, lib, mode: int, cores: int, ram_k: int, inputs: dict):
    """A function that launches ``lib``'s kernel on ``inputs`` and returns
    its outputs."""
    from asyncflow_tpu_torch.engines.torchsim import station_scan

    a = inputs["a"]
    outs = [torch.empty_like(a) for _ in range(3 if mode == station_scan.MODE_RAM_CORE else 1)]
    width = lib.station_scan_scratch_floats(mode, cores, ram_k)
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", default="16,32")
    parser.add_argument("--ahead", default="0,256")
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
    for rows in (int(r) for r in opts.rows.split(",")):
        for ahead in (int(x) for x in opts.ahead.split(",")):
            name = f"station_scan_rows{rows}_ahead{ahead}"
            _build.SOURCES[name] = (src, (f"-DSTATION_ROWS={rows}", f"-DSTATION_AHEAD={ahead}"))
            names.append(name)
    _build.build(names)
    libs = {}
    for name in names:
        lib = _build.load(name)
        lib.station_scan_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.station_scan_scratch_floats.argtypes = [ctypes.c_int] * 3
        libs[name] = lib
    cases = {
        "waits c=1 (2048 x 87840)": (station_scan.MODE_LINDLEY, 1, 0,
                                     streams(torch, 2048, 87_840, 133.0, 0.002, 0)),
        "ram_core k=20 c=1 (2048 x 20280)": (station_scan.MODE_RAM_CORE, 1, 20,
                                             streams(torch, 2048, 20_280, 40.0, 0.001, 1)),
    }
    for case, (mode, cores, ram_k, inputs) in cases.items():
        first = None
        for name, lib in libs.items():
            run = launcher(torch, lib, mode, cores, ram_k, inputs)
            out = [x.clone() for x in run()]
            if first is None:
                first = out
            elif not all(torch.equal(x, y) for x, y in zip(out, first, strict=True)):
                print(f"{case}: {name} differs from {names[0]}", file=sys.stderr)
                return 1
            ms = chip_smoke.time_kernel(torch, run, repeats=5)
            print(f"{case}: {name} {ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
