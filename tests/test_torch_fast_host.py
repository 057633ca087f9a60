"""The fast path's CUDA sources, compiled for the host CPU, against their
plain PyTorch versions.

``csrc/edge_draws.cu`` and ``csrc/station_scan.cu`` are plain C++ apart
from CUDA's qualifiers, thread indices and launches.  Built with g++
through a shim header that defines those away (a launch becomes a loop
over blocks and threads), each runs here through its wrapper's own
argument struct and is held to its plain version on the CPU.  This checks
the kernels' logic and argument layout, not the CUDA compiler: the card's
builds are held to the plain versions by ``tests/test_torch_fast_cuda.py``
and ``chip_smoke.py``.  Both sides round every float operation on its own
(``-ffp-contract=off``); the uniforms, drops and station recursions
(adds, subtracts and maxima) are compared exactly, the delays within 4
ulps (glibc's ``logf``, ``log1pf`` and ``expf`` may round a value
differently from torch's).  Skipped where no g++ is installed.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from asyncflow_tpu_torch.engines.torchsim import draws, station_scan
from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
from asyncflow_tpu_torch.engines.torchsim.sampling import (
    D_EXPONENTIAL,
    D_LOGNORMAL,
    D_NORMAL,
    D_UNIFORM,
)

CSRC = Path(draws.__file__).resolve().parents[2] / "csrc"

SHIM = """
#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#define __device__
#define __global__
#define __forceinline__ inline
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(4) uchar4 { unsigned char x, y, z, w; };
struct HostDim { unsigned x; };
static HostDim blockIdx, blockDim, threadIdx;
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
inline float __uint_as_float(unsigned x) { float f; std::memcpy(&f, &x, 4); return f; }
"""
LAUNCH = re.compile(
    r"(\w+)<<<\(unsigned\)blocks, threads, 0, \(cudaStream_t\)stream>>>\(a\);",
)
HOST_LAUNCH = (
    r"for (unsigned b = 0; b < (unsigned)blocks; ++b)"
    r" for (unsigned t = 0; t < (unsigned)threads; ++t) {"
    r" blockIdx.x = b; blockDim.x = threads; threadIdx.x = t; \1(a); }"
)


def _build(tmp: Path, name: str) -> ctypes.CDLL:
    src = (CSRC / f"{name}.cu").read_text()
    assert "#include <cuda_runtime.h>" in src
    assert LAUNCH.search(src), "the launch statement changed: update LAUNCH"
    src = LAUNCH.sub(HOST_LAUNCH, src.replace("#include <cuda_runtime.h>", '#include "shim.h"'))
    (tmp / "shim.h").write_text(SHIM)
    (tmp / f"{name}.cpp").write_text(src)
    lib = tmp / f"lib{name}_host.so"
    out = subprocess.run(  # noqa: S603 - fixed argv
        [shutil.which("g++"), "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", "-o", str(lib), str(tmp / f"{name}.cpp")],
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory) -> dict[str, ctypes.CDLL]:
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel sources for the host")
    tmp = tmp_path_factory.mktemp("fast_host")
    libs = {name: _build(tmp, name) for name in ("edge_draws", "station_scan")}
    for name, lib in libs.items():
        getattr(lib, f"{name}_launch").argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        getattr(lib, f"{name}_launch").restype = ctypes.c_int
        getattr(lib, f"{name}_args_size").restype = ctypes.c_int
    assert libs["edge_draws"].edge_draws_args_size() == ctypes.sizeof(draws._EdgeDrawArgs)
    assert libs["station_scan"].station_scan_args_size() == ctypes.sizeof(
        station_scan._StationArgs)
    return libs


def _launch(lib, fn: str, args) -> None:
    assert getattr(lib, fn)(ctypes.byref(args), None) == 0


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max())


S, N = 3, 4099
#: one edge of each law the fast path draws, with dropout on two
DIST = np.array([D_UNIFORM, D_EXPONENTIAL, D_NORMAL, D_LOGNORMAL], np.int32)


def _edge_params():
    g = np.random.default_rng(5)
    mean = torch.tensor(g.uniform(0.001, 0.01, (S, 4)), dtype=torch.float32)
    var = torch.tensor(g.uniform(0.0005, 0.3, (S, 4)), dtype=torch.float32)
    drop = torch.tensor(np.tile([0.0, 0.05, 0.0, 0.2], (S, 1)), dtype=torch.float32)
    return mean, var, drop


def test_uniform_matches_plain(host_libs) -> None:
    keys = scenario_keys(11, S)
    out = torch.empty((S, N), dtype=torch.float32)
    kw = draws.key_words(keys)
    args = draws._EdgeDrawArgs(ukey=kw.data_ptr(), u_out=out.data_ptr(), S=S, n=N,
                               mode=draws.MODE_UNIFORM, edge=-1)
    _launch(host_libs["edge_draws"], "edge_draws_launch", args)
    assert torch.equal(out, draws.uniform(keys, N))


@pytest.mark.parametrize("per_lane", [False, True])
@pytest.mark.parametrize("shared_u", [False, True])
def test_hop_matches_plain(host_libs, per_lane: bool, shared_u: bool) -> None:
    keys = scenario_keys(12, S)
    uk, zk = draws.hop_keys(keys, 32)
    mean, var, drop = _edge_params()
    u = draws.uniform(scenario_keys(13, S), N) if shared_u else draws.uniform(uk, N)
    eidx = torch.tensor(np.random.default_rng(1).integers(0, 4, (S, N)), dtype=torch.int32)
    edges = [None] if per_lane else list(range(4))
    for edge in edges:
        kw = {"eidx": eidx} if per_lane else {"edge": edge}
        want_drop, want_delay = draws.edge_hop_plain(u, zk, DIST, mean, var, drop, **kw)
        dropped = torch.empty((S, N), dtype=torch.bool)
        delay = torch.empty((S, N), dtype=torch.float32)
        dist = torch.tensor(DIST)
        ukw, zkw = draws.key_words(uk), draws.key_words(zk)
        args = draws._EdgeDrawArgs(
            ukey=0 if shared_u else ukw.data_ptr(), zkey=zkw.data_ptr(),
            u_in=u.data_ptr() if shared_u else 0,
            eidx=eidx.data_ptr() if per_lane else 0,
            mean=mean.data_ptr(), var=var.data_ptr(), drop=drop.data_ptr(),
            dist=dist.data_ptr(), dropped=dropped.data_ptr(), delay=delay.data_ptr(),
            S=S, n=N, NE=4, edge=-1 if per_lane else edge, mode=draws.MODE_HOP,
        )
        _launch(host_libs["edge_draws"], "edge_draws_launch", args)
        assert torch.equal(dropped, want_drop), edge
        assert _ulps(delay, want_delay) <= 4, edge


def _stream(seed: int, m: int, rate: float, svc: float):
    """Sorted arrivals at ``rate`` with exponential services, a third of the
    lanes invalid (another station's), and each row's tail padded INF."""
    g = np.random.default_rng(seed)
    a = np.cumsum(g.exponential(1.0 / rate, (S, m)), axis=1).astype(np.float32)
    d = g.exponential(svc, (S, m)).astype(np.float32)
    v = g.random((S, m)) > 0.33
    v[:, -50:] = False
    a[:, -50:] = 1e30
    return torch.tensor(a), torch.tensor(d), torch.tensor(v)


@pytest.mark.parametrize(("cores", "placement"),
                         [(1, None), (3, None), (8, None), (3, "global"), (9, "global")])
def test_station_waits_match_plain(host_libs, cores: int, placement) -> None:
    # rows of 3001: each row starts at another offset from a 16-byte boundary
    a, d, v = _stream(3, 3001, rate=40.0 * cores, svc=0.02)
    out = torch.empty_like(a)
    scratch = torch.empty((S, cores), dtype=torch.float32)
    mode = station_scan.MODE_LINDLEY if cores == 1 else station_scan.MODE_KW
    args = station_scan._StationArgs(
        a=a.data_ptr(), d=d.data_ptr(), v=v.data_ptr(), out0=out.data_ptr(),
        scratch=scratch.data_ptr() if placement == "global" else 0,
        S=S, m=a.shape[1], mode=mode, cores=cores, ram_k=0,
    )
    _launch(host_libs["station_scan"], "station_scan_launch", args)
    want = (station_scan.lindley_plain(a, d, v) if cores == 1
            else station_scan.kw_plain(a, d, v, cores))
    assert torch.equal(out, want)
    assert float(want[v].max()) > 0.0


@pytest.mark.parametrize(("ram_k", "cores", "placement"),
                         [(3, 1, None), (5, 2, None), (32, 8, None), (20, 2, "global"),
                          (70, 1, "global")])
def test_ram_core_matches_plain(host_libs, ram_k: int, cores: int, placement) -> None:
    a, d, v = _stream(4, 2501, rate=60.0, svc=0.01)
    g = np.random.default_rng(9)
    pre = torch.tensor(np.full((S, a.shape[1]), 0.001, np.float32))
    # residence about 1.5x what the slots hold at the arrival rate: admission binds
    post = torch.tensor(g.exponential(1.5 * ram_k / 60.0, (S, a.shape[1])).astype(np.float32))
    d = torch.where(torch.tensor(g.random((S, a.shape[1])) < 0.1), 0.0, d)  # IO-only lanes
    outs = [torch.empty_like(a) for _ in range(3)]
    scratch = torch.empty((S, ram_k + cores), dtype=torch.float32)
    args = station_scan._StationArgs(
        a=a.data_ptr(), d=d.data_ptr(), v=v.data_ptr(), pre=pre.data_ptr(),
        post=post.data_ptr(), out0=outs[0].data_ptr(), out1=outs[1].data_ptr(),
        out2=outs[2].data_ptr(), scratch=scratch.data_ptr() if placement else 0,
        S=S, m=a.shape[1], mode=station_scan.MODE_RAM_CORE, cores=cores, ram_k=ram_k,
    )
    _launch(host_libs["station_scan"], "station_scan_launch", args)
    want = station_scan.ram_core_plain(a, pre, d, post, v, ram_k, cores)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    assert float(want[0][v].max()) > 0.0


def test_wide_carry_needs_scratch(host_libs) -> None:
    """A carry past the registers needs global scratch, and is refused
    without it; the wrapper's constants are the source's."""
    lib = host_libs["station_scan"]
    floats = lib.station_scan_scratch_floats
    cores, slots = station_scan.REG_CORES, station_scan.REG_SLOTS
    assert floats(station_scan.MODE_LINDLEY, 1, 0) == 0
    assert floats(station_scan.MODE_KW, cores, 0) == 0
    assert floats(station_scan.MODE_KW, cores + 1, 0) == cores + 1
    assert floats(station_scan.MODE_RAM_CORE, cores, slots) == 0
    assert floats(station_scan.MODE_RAM_CORE, cores + 1, 1) == cores + 2
    assert floats(station_scan.MODE_RAM_CORE, 1, slots + 1) == slots + 2
    a, d, v = _stream(5, 64, rate=10.0, svc=0.01)
    out = torch.empty_like(a)
    args = station_scan._StationArgs(
        a=a.data_ptr(), d=d.data_ptr(), v=v.data_ptr(), pre=a.data_ptr(), post=a.data_ptr(),
        out0=out.data_ptr(), out1=out.data_ptr(), out2=out.data_ptr(), scratch=0,
        S=S, m=a.shape[1], mode=station_scan.MODE_RAM_CORE, cores=1, ram_k=slots + 1,
    )
    assert lib.station_scan_launch(ctypes.byref(args), None) == -1
