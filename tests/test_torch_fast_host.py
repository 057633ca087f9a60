"""The fast path's CUDA sources, compiled for the host CPU, against their
plain PyTorch versions.

``csrc/edge_draws.cu``, ``csrc/station_scan.cu``, ``csrc/lb_route.cu`` and
``csrc/gauge_grid.cu`` are plain C++ apart
from CUDA's qualifiers, thread indices, shared memory and launches.  Built
with g++ through a shim header that defines those away (a launch becomes
a loop over the grid's rows and blocks and the block's threads, one thread
after another; the dynamic shared memory a static buffer), each runs here
through its wrapper's own argument struct and is held to its plain version
on the CPU.  This checks the kernels' logic and argument layout, not the
CUDA compiler: the card's builds are held to the plain versions by
``tests/test_torch_fast_cuda.py`` and ``chip_smoke.py``.  Both sides round
every float operation on its own (``-ffp-contract=off``); the uniforms,
gaps, block sums, drops, masks, LB targets and station recursions (adds,
subtracts and maxima) are compared exactly, the delays and hop times
within 4 ulps (glibc's ``logf``, ``log1pf`` and ``expf`` may round a
value differently from torch's), and the gauge spans, float64 sums in one
fixed order, exactly where the hop times agree, else within 1 ulp.
The gauge grid's sums of whole amounts are compared exactly.
``station_scan.cu`` is built without optimisation (its 132 host instances
took ~30 s of g++ at ``-O2`` and take ~4 s at ``-O0``; its checks run a
little slower); the others at ``-O2``.  Skipped where no g++ is installed.
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
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    one_torch_thread,
    torch_inference_mode,
)

from asyncflow_tpu_torch.engines.torchsim import _build, draws, gauge_grid, routing, station_scan
from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
from asyncflow_tpu_torch.engines.torchsim.sampling import (
    D_EXPONENTIAL,
    D_LOGNORMAL,
    D_NORMAL,
    D_UNIFORM,
)

one_torch_thread()

CSRC = Path(draws.__file__).resolve().parents[2] / "csrc"

SHIM = """
#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#define __device__
#define __global__
#define __shared__
#define __forceinline__ inline
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(16) longlong2 { long long x, y; };
struct alignas(4) uchar4 { unsigned char x, y, z, w; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct HostDim { unsigned x, y; };
static HostDim blockIdx, blockDim, threadIdx, gridDim;
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
inline float __uint_as_float(unsigned x) { float f; std::memcpy(&f, &x, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned x; std::memcpy(&x, &f, 4); return x; }
inline unsigned atomicAdd(unsigned* p, unsigned v) { unsigned old = *p; *p += v; return old; }
inline float atomicAdd(float* p, float v) { float old = *p; *p += v; return old; }
#define __launch_bounds__(...)
#define __host__
inline void __syncwarp(unsigned = 0xffffffffu) {}
inline void __syncthreads() {}
template <class T> inline T __shfl_sync(unsigned, T v, int) { return v; }
template <class T> inline T __shfl_down_sync(unsigned, T v, unsigned) { return v; }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int) { return v; }
inline int __all_sync(unsigned, int p) { return p; }
inline unsigned __reduce_add_sync(unsigned, unsigned v) { return v; }
inline unsigned __reduce_min_sync(unsigned, unsigned v) { return v; }
inline unsigned __ballot_sync(unsigned, int p) { return p ? 1u : 0u; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
"""
#: a one-dimensional launch (station_scan.cu) and a launch on dim3 grids
#: (edge_draws.cu, lb_route.cu), each made a loop that runs the threads one
#: after another; a kernel may be a template's instance
LAUNCH = re.compile(
    r"(\w+(?:<[^<>;]*>)?)<<<\(unsigned\)blocks, threads, 0, "
    r"\(cudaStream_t\)stream>>>\(a\);",
)
HOST_LAUNCH = (
    r"for (unsigned b = 0; b < (unsigned)blocks; ++b)"
    r" for (unsigned t = 0; t < (unsigned)threads; ++t) {"
    r" blockIdx.x = b; blockDim.x = threads; threadIdx.x = t; \1(a); }"
)
LAUNCH_2D = re.compile(
    r"(\w+(?:<[^<>;]*>)?)<<<(\w+), (\w+), \w+, \(cudaStream_t\)stream>>>\(a\);",
)
HOST_LAUNCH_2D = (
    r"for (unsigned gy = 0; gy < \2.y; ++gy) for (unsigned gx = 0; gx < \2.x; ++gx)"
    r" for (unsigned t = 0; t < \3.x; ++t) {"
    r" gridDim.x = \2.x; gridDim.y = \2.y; blockIdx.x = gx; blockIdx.y = gy;"
    r" blockDim.x = \3.x; threadIdx.x = t; \1(a); }"
)
#: the dynamic shared memory of edge_draws.cu's hop and of lb_route.cu's
#: table, as static buffers
HOST_SMEM = {"edge_draws": "uint4 edge_smem[1 << 12];\n",
             "lb_route": "uint32_t route_smem[1 << 14];\n",
             "gauge_grid": "float gauge_smem[2048];\n"}
#: the launch statements on dim3 grids each source has
LAUNCHES_2D = {"edge_draws": 4, "lb_route": 4, "gauge_grid": 2}
#: g++'s optimisation of each host build
HOST_OPT = {"station_scan": "-O0"}


def _start(tmp: Path, name: str) -> tuple[subprocess.Popen, Path]:
    """g++ of ``name``'s host build, started; :func:`_finish` waits for it."""
    src = (CSRC / f"{name}.cu").read_text()
    assert "#include <cuda_runtime.h>" in src
    src = src.replace("#include <cuda_runtime.h>", '#include "shim.h"')
    if name in LAUNCHES_2D:
        assert len(LAUNCH_2D.findall(src)) == LAUNCHES_2D[name], \
            "the launch statements changed: update LAUNCH_2D"
        src = LAUNCH_2D.sub(HOST_LAUNCH_2D, src) + HOST_SMEM[name]
    else:
        assert len(LAUNCH.findall(src)) == 5, "the launch statements changed: update LAUNCH"
        src = LAUNCH.sub(HOST_LAUNCH, src)
    if not (tmp / "shim.h").exists():  # builds running at once share it
        (tmp / "shim.h").write_text(SHIM)
    (tmp / f"{name}.cpp").write_text(src)
    lib = tmp / f"lib{name}_host.so"
    proc = subprocess.Popen(  # noqa: S603 - fixed argv
        [shutil.which("g++"), "-std=c++17", HOST_OPT.get(name, "-O2"), "-ffp-contract=off",
         "-shared", "-fPIC",
         "-Wno-unknown-pragmas", "-o", str(lib), str(tmp / f"{name}.cpp")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return proc, lib


def _finish(proc: subprocess.Popen, lib: Path) -> ctypes.CDLL:
    try:
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory) -> dict[str, ctypes.CDLL]:
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel sources for the host")
    tmp = tmp_path_factory.mktemp("fast_host")
    # the four g++ builds at once
    started = {name: _start(tmp, name)
               for name in ("station_scan", "edge_draws", "lb_route", "gauge_grid")}
    libs = {name: _finish(*job) for name, job in started.items()}
    for name, lib in libs.items():
        getattr(lib, f"{name}_launch").argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        getattr(lib, f"{name}_launch").restype = ctypes.c_int
        getattr(lib, f"{name}_args_size").restype = ctypes.c_int
    assert libs["edge_draws"].edge_draws_args_size() == ctypes.sizeof(draws._EdgeDrawArgs)
    libs["edge_draws"].edge_draws_lane_block.restype = ctypes.c_int
    assert libs["edge_draws"].edge_draws_lane_block() == draws.BLOCK_THREADS * draws.THREAD_LANES
    assert libs["station_scan"].station_scan_args_size() == ctypes.sizeof(
        station_scan._StationArgs)
    assert libs["lb_route"].lb_route_args_size() == ctypes.sizeof(routing._LbRouteArgs)
    assert libs["gauge_grid"].gauge_grid_args_size() == ctypes.sizeof(
        gauge_grid._GaugeGridArgs)
    libs["gauge_grid"].gauge_grid_shared_rows.restype = ctypes.c_int
    return libs


@pytest.fixture(autouse=True)
def _one_thread():
    """Torch on one thread while these checks run: on the CPU, after the
    host build's launches, torch's multithreaded passes have returned a
    few wrong lanes in some runs (a run on one thread never has)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _launch(lib, fn: str, args) -> None:
    assert getattr(lib, fn)(ctypes.byref(args), None) == 0


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max())


S, N = 3, 4099
#: one edge of each law the fast path draws, with dropout on two
DIST = np.array([D_UNIFORM, D_EXPONENTIAL, D_NORMAL, D_LOGNORMAL], np.int32)


def _edge_params(rows: int = S):
    g = np.random.default_rng(5)
    mean = torch.tensor(g.uniform(0.001, 0.01, (rows, 4)), dtype=torch.float32)
    var = torch.tensor(g.uniform(0.0005, 0.3, (rows, 4)), dtype=torch.float32)
    drop = torch.tensor(np.tile([0.0, 0.05, 0.0, 0.2], (rows, 1)), dtype=torch.float32)
    return mean, var, drop


@pytest.mark.parametrize("gap", [False, True])
def test_uniform_matches_plain(host_libs, gap: bool) -> None:
    keys = scenario_keys(11, S)
    out = torch.empty((S, N), dtype=torch.float32)
    kw = draws.key_words(keys)
    args = draws._EdgeDrawArgs(ukey=kw.data_ptr(), out=out.data_ptr(), S=S, n=N,
                               mode=draws.MODE_UNIFORM, edge=-1, K=1, gap=int(gap))
    _launch(host_libs["edge_draws"], "edge_draws_launch", args)
    assert torch.equal(out, draws.PlainEdgeDraws().uniform(keys, N, gap=gap))


def test_gap_of_every_uniform_matches_plain(host_libs) -> None:
    """log1p_xla on each of the 2**23 uniforms, through the uniform mode's
    given inputs (rows of 2**20)."""
    u = torch.arange(2**23, dtype=torch.float64).div(2**23).float().view(8, 2**20)
    out = torch.empty_like(u)
    args = draws._EdgeDrawArgs(x_in=u.data_ptr(), out=out.data_ptr(), S=8, n=2**20,
                               mode=draws.MODE_UNIFORM, edge=-1, K=1, gap=1)
    _launch(host_libs["edge_draws"], "edge_draws_launch", args)
    assert torch.equal(out, draws.PlainEdgeDraws().gap_of(u))


def _host_gap_sum(lib, s: int, n: int, ukey: torch.Tensor) -> torch.Tensor:
    """EdgeDraws.gap_cumsum on the host build: one gaps-mode launch, (s,
    n + 1) with the leading zero."""
    out = torch.full((s, n + 1), float("nan"), dtype=torch.float32)
    args = draws._EdgeDrawArgs(ukey=ukey.data_ptr(), out=out.data_ptr(), S=s, n=n, ld_out=n + 1,
                               mode=draws.MODE_GAPS, edge=-1, K=1)
    _launch(lib, "edge_draws_launch", args)
    return out


#: row lengths of the gap prefix sum: one to six levels of XLA's scan (a
#: block of 16, one past it, a tile of 4096 and one past it, the five
#: levels of 70,000 and of the headline's 87,840 lanes, and 16^5 + 1)
GAP_SUM_LANES = [1, 16, 17, 4096, 4099, 40_000, 70_000, 87_840, 16**5 + 1]


@pytest.mark.parametrize("n", GAP_SUM_LANES)
def test_gap_cumsum_matches_plain(host_libs, n: int) -> None:
    """The gaps mode in one pass a row: XLA's base-16 scan, bit for bit,
    after a leading zero (fewer rows past 65,536 lanes)."""
    s = S if n <= 65_536 else 2 if n < 16**5 else 1
    keys = scenario_keys(14, s)
    got = _host_gap_sum(host_libs["edge_draws"], s, n, draws.key_words(keys))
    assert torch.equal(got, draws.PlainEdgeDraws().gap_cumsum(keys, n))
    assert torch.equal(got[:, 1:], draws.prefix_sum_xla(draws.gaps(keys, n)))


def _spike_tables():
    """Breakpoints 0, 0.5, 1.5 with spikes on edges 1 and 3."""
    spike_t = torch.tensor([0.0, 0.5, 1.5], dtype=torch.float32)
    spike_v = torch.zeros((3, 4), dtype=torch.float32)
    spike_v[1, 1], spike_v[1, 3], spike_v[2, 3] = 0.25, 0.125, 0.5
    return spike_t, spike_v


def _own_spans(out, t_send, pick: torch.Tensor | None, k_slots: int) -> torch.Tensor:
    """Each slot's gauge span from the kernel's own lanes (its t_next and
    ok; ``pick`` each lane's slot, None on a static edge), summed in the
    kernel's order: what the kernel's spans must equal bit for bit."""
    h = torch.tensor(2.0, dtype=torch.float32)
    lane = torch.where(out.ok, torch.clamp_min(
        torch.clamp_max(out.t_next, h) - torch.clamp_max(t_send, h), 0.0), 0.0).double()
    if pick is None:
        return draws.lane_block_sum(lane)[:, None].float()
    return torch.stack([draws.lane_block_sum(torch.where(pick == k, lane, 0.0))
                        for k in range(k_slots)], dim=1).float()


#: (rows, lanes a row) of the hop's checks: rows of 4099 lanes (most start
#: off a 16-byte boundary), then 17 rows (every row residue mod 16) of
#: widths 1, 3, 8 and 15 mod 16, two of them past one block of 2048 lanes
HOP_WIDTHS = [(S, N), (17, 17), (17, 2051), (17, 40), (17, 4111)]


@pytest.mark.parametrize(("rows", "n"), HOP_WIDTHS)
@pytest.mark.parametrize("lb", [False, True])
@pytest.mark.parametrize("spikes", [False, True])
def test_hop_matches_plain(host_libs, lb: bool, spikes: bool, rows: int, n: int) -> None:
    """The fused hop over every static edge, or over three LB slots (edges
    3, 1, 2; slot = rank % 3), with and without spikes, at each of
    HOP_WIDTHS: per-lane outputs exact but for the delays' libm rounding,
    drop counts exact, spans within 1 ulp."""
    S, N = rows, n  # noqa: N806 - the module's names for the shape
    keys = scenario_keys(12, S)
    uk, zk = draws.hop_keys(keys, 32)
    mean, var, drop = _edge_params(S)
    g = np.random.default_rng(1)
    t_send = torch.tensor(g.uniform(0.0, 2.2, (S, N)), dtype=torch.float32)
    alive = torch.tensor(g.random((S, N)) > 0.1)
    rank = torch.tensor(g.permuted(np.tile(np.arange(N), (S, 1)), axis=1), dtype=torch.int64)
    spike_t, spike_v = _spike_tables() if spikes else (None, None)
    tables = draws.EdgeTables(
        dist=DIST, mean=mean, var=var, drop=drop, horizon=2.0,
        lb_edge=torch.tensor([3, 1, 2], dtype=torch.int32) if lb else None,
        lb_target=torch.tensor([0, 1, 2], dtype=torch.int32) if lb else None,
        spike_t=spike_t, spike_v=spike_v,
    )
    edges = [None] if lb else list(range(4))
    dist = torch.tensor(DIST)
    for edge in edges:
        kw = {"rank": rank} if lb else {"edge": edge}
        want = draws.hop_plain(tables, t_send, alive, uk, zk, **kw)
        k_slots = 3 if lb else 1
        out = draws.HopOut(
            t_next=torch.empty((S, N), dtype=torch.float32),
            ok=torch.empty((S, N), dtype=torch.bool),
            target=torch.empty((S, N), dtype=torch.int32) if lb else None,
            span=torch.empty((S, k_slots), dtype=torch.float32),
            dropped=torch.empty(S, dtype=torch.int64),
        )
        partial = torch.empty((S, draws.lane_blocks(N), k_slots + 1), dtype=torch.float64)
        ukw, zkw = draws.key_words(uk), draws.key_words(zk)
        ptr = lambda x: 0 if x is None else x.data_ptr()  # noqa: E731
        args = draws._EdgeDrawArgs(
            ukey=ukw.data_ptr(), zkey=zkw.data_ptr(), t_send=t_send.data_ptr(),
            alive=alive.data_ptr(), rank=ptr(rank if lb else None),
            lb_edge=ptr(tables.lb_edge), lb_target=ptr(tables.lb_target),
            mean=mean.data_ptr(), var=var.data_ptr(), drop=drop.data_ptr(),
            dist=dist.data_ptr(), spike_t=ptr(spike_t), spike_v=ptr(spike_v),
            out=out.t_next.data_ptr(), ok=out.ok.data_ptr(), target=ptr(out.target),
            partial=partial.data_ptr(), span=out.span.data_ptr(),
            dropped=out.dropped.data_ptr(), S=S, n=N, horizon=2.0, NE=4,
            NB=0 if spike_t is None else 3, K=k_slots, edge=-1 if lb else edge,
            mode=draws.MODE_HOP,
        )
        _launch(host_libs["edge_draws"], "edge_draws_launch", args)
        assert torch.equal(out.ok, want.ok), edge
        assert torch.equal(out.dropped, want.dropped), edge
        assert want.dropped.sum() > 0 or edge in (0, 2) or N < 100, edge
        if lb:
            assert torch.equal(out.target, want.target)
        assert _ulps(out.t_next, want.t_next) <= 4, edge
        if torch.equal(out.t_next, want.t_next):
            # the same lanes: the float64 sums in one order are the same
            assert torch.equal(out.span, want.span), edge
        gate = alive & (t_send < 2.0)
        pick = torch.where(gate, rank % 3, 0) if lb else None
        assert torch.equal(out.span, _own_spans(out, t_send, pick, k_slots)), edge
        if N == HOP_WIDTHS[0][1]:
            # a row of few lanes carries one lane's libm rounding into its span
            assert _ulps(out.span, want.span) <= 1, edge
        assert bool((want.span > 0).all()) or N < 100, edge


@pytest.mark.parametrize(("rows", "n"), HOP_WIDTHS)
@pytest.mark.parametrize("spikes", [False, True])
def test_hop_slot_matches_plain(host_libs, spikes: bool, rows: int, n: int) -> None:
    """The LB hop over a given slot a lane (three slots, a tenth of the
    lanes -1: no healthy target, dropped at the LB) at each of HOP_WIDTHS:
    the same checks as the rank form's."""
    S, N = rows, n  # noqa: N806 - the module's names for the shape
    keys = scenario_keys(13, S)
    uk, zk = draws.hop_keys(keys, 32)
    mean, var, drop = _edge_params(S)
    g = np.random.default_rng(2)
    t_send = torch.tensor(g.uniform(0.0, 2.2, (S, N)), dtype=torch.float32)
    alive = torch.tensor(g.random((S, N)) > 0.1)
    slot = torch.tensor(np.where(g.random((S, N)) < 0.1, -1, g.integers(0, 3, (S, N))),
                        dtype=torch.int32)
    spike_t, spike_v = _spike_tables() if spikes else (None, None)
    tables = draws.EdgeTables(
        dist=DIST, mean=mean, var=var, drop=drop, horizon=2.0,
        lb_edge=torch.tensor([3, 1, 2], dtype=torch.int32),
        lb_target=torch.tensor([0, 1, 2], dtype=torch.int32),
        spike_t=spike_t, spike_v=spike_v,
    )
    want = draws.hop_plain(tables, t_send, alive, uk, zk, slot=slot)
    out = draws.HopOut(
        t_next=torch.empty((S, N), dtype=torch.float32),
        ok=torch.empty((S, N), dtype=torch.bool),
        target=torch.empty((S, N), dtype=torch.int32),
        span=torch.empty((S, 3), dtype=torch.float32),
        dropped=torch.empty(S, dtype=torch.int64),
    )
    partial = torch.empty((S, draws.lane_blocks(N), 4), dtype=torch.float64)
    ukw, zkw, dist = draws.key_words(uk), draws.key_words(zk), torch.tensor(DIST)
    ptr = lambda x: 0 if x is None else x.data_ptr()  # noqa: E731
    args = draws._EdgeDrawArgs(
        ukey=ukw.data_ptr(), zkey=zkw.data_ptr(), t_send=t_send.data_ptr(),
        alive=alive.data_ptr(), slot=slot.data_ptr(),
        lb_edge=ptr(tables.lb_edge), lb_target=ptr(tables.lb_target),
        mean=mean.data_ptr(), var=var.data_ptr(), drop=drop.data_ptr(),
        dist=dist.data_ptr(), spike_t=ptr(spike_t), spike_v=ptr(spike_v),
        out=out.t_next.data_ptr(), ok=out.ok.data_ptr(), target=out.target.data_ptr(),
        partial=partial.data_ptr(), span=out.span.data_ptr(),
        dropped=out.dropped.data_ptr(), S=S, n=N, horizon=2.0, NE=4,
        NB=0 if spike_t is None else 3, K=3, edge=-1, mode=draws.MODE_HOP,
    )
    _launch(host_libs["edge_draws"], "edge_draws_launch", args)
    gate = alive & (t_send < 2.0)
    assert int((gate & (slot < 0)).sum()) > 0
    assert torch.equal(out.ok, want.ok)
    assert torch.equal(out.dropped, want.dropped)
    assert torch.equal(out.target, want.target)
    assert not bool((want.ok & (slot < 0)).any())
    assert _ulps(out.t_next, want.t_next) <= 4
    if torch.equal(out.t_next, want.t_next):
        assert torch.equal(out.span, want.span)
    pick = torch.where(gate & (slot >= 0), slot.long(), 0)
    assert torch.equal(out.span, _own_spans(out, t_send, pick, 3))
    if N == HOP_WIDTHS[0][1]:
        # a row of few lanes carries one lane's libm rounding into its span
        assert _ulps(out.span, want.span) <= 1


#: outage timelines over three LB slots: (times, down, slot), in table order
TIMELINES = {
    "no_marks": ([], [], []),
    "two_outages": ([0.4, 0.9, 1.2, 1.6], [1, 0, 1, 0], [0, 0, 2, 2]),
    "all_down_same_time": ([0.3, 0.5, 0.5, 0.8, 0.8, 1.4, 1.4],
                           [1, 1, 1, 0, 0, 0, 1], [1, 0, 2, 0, 2, 1, 0]),
    "present_absent_unknown": ([0.2, 0.2, 0.6, 1.0], [0, 1, 1, 0], [1, 2, -1, 0]),
    "before_and_after": ([-1.0, 0.0, 5.0, 6.0], [1, 0, 1, 0], [2, 2, 1, 1]),
    # more marks than the count kernel holds in one pass (kMarksAPass = 16),
    # some at one time, over a row of several count blocks
    "many_marks": ([0.05 * k + (0.0 if k % 5 else 0.025) for k in range(21)]
                   + [1.025, 1.025], [1, 0] * 11 + [1],
                   [k % 3 for k in range(21)] + [1, 2]),
}
#: lanes a row of each timeline's case: 4099 (most rows start unaligned),
#: and past one count block (8192 lanes) where the marks take two passes
ROUTE_LANES = {"many_marks": 9001}


@pytest.mark.parametrize("name", sorted(TIMELINES))
def test_lb_route_matches_plain(host_libs, name: str) -> None:
    """Both lb_route kernels on rows of 4099 lanes, or 9001 (a tenth dead),
    against the segment form, exactly, and the slots against the
    arrival-by-arrival replay of the reference's scan."""
    from asyncflow_tpu_torch.engines.torchsim.sortutil import time_rank

    n = ROUTE_LANES.get(name, N)
    g = np.random.default_rng(4)
    t = torch.tensor(np.round(g.uniform(0.0, 2.0, (S, n)), 3), dtype=torch.float32)
    alive = torch.tensor(g.random((S, n)) > 0.1)
    times, down, slots = TIMELINES[name]
    tl = routing.Timeline(times, down, slots, 3, "cpu")
    if tl.n_marks:
        t[0, :5] = tl.times[-1]  # arrivals at exactly a mark's time
    lib = host_libs["lb_route"]
    table = torch.empty((S, tl.n_marks + 1, 5), dtype=torch.int32)
    lib.lb_route_row_blocks.argtypes = [ctypes.c_int64]
    lib.lb_route_row_blocks.restype = ctypes.c_int64
    blocks = lib.lb_route_row_blocks(n)
    assert blocks == (2 if n > 8192 else 1)
    partial = torch.empty((S, blocks, tl.n_marks), dtype=torch.int32)
    args = routing._LbRouteArgs(
        t=t.data_ptr(), alive=alive.data_ptr(), table=table.data_ptr(),
        partial=partial.data_ptr() if tl.n_marks else 0,
        tl_time=tl.times.data_ptr() if tl.n_marks else 0,
        tl_down=tl.down.data_ptr() if tl.n_marks else 0,
        tl_slot=tl.slot.data_ptr() if tl.n_marks else 0,
        S=S, n=n, NTL=tl.n_marks, EL=3, mode=routing.MODE_TABLE,
    )
    _launch(lib, "lb_route_launch", args)
    want_table = routing.PlainLbRoute().table(tl, t, alive)
    assert torch.equal(table, want_table)
    rank = time_rank(t, alive)
    slot = torch.empty((S, n), dtype=torch.int32)
    args = routing._LbRouteArgs(
        rank=rank.data_ptr(), alive=alive.data_ptr(), table=table.data_ptr(),
        slot=slot.data_ptr(), S=S, n=n, NTL=tl.n_marks, EL=3, mode=routing.MODE_LANES,
    )
    _launch(lib, "lb_route_launch", args)
    assert torch.equal(slot, routing.PlainLbRoute().slots(want_table, rank, alive))
    scan, _ = routing.routed_slots_scan(t, alive, tl.times, tl.down, tl.slot, 3)
    assert torch.equal(slot, scan)


#: rows of the scan tests: two blocks of the warp walk's four rows, the
#: second part-full; each row starts at another offset from a line
SCAN_ROWS = 5


def _stream(seed: int, m: int, rate: float, svc: float):
    """Sorted arrivals at ``rate`` with exponential services, a third of the
    lanes invalid (another station's), and each row's tail padded INF."""
    g = np.random.default_rng(seed)
    a = np.cumsum(g.exponential(1.0 / rate, (SCAN_ROWS, m)), axis=1).astype(np.float32)
    d = g.exponential(svc, (SCAN_ROWS, m)).astype(np.float32)
    v = g.random((SCAN_ROWS, m)) > 0.33
    v[:, -50:] = False
    a[:, -50:] = 1e30
    return torch.tensor(a), torch.tensor(d), torch.tensor(v)


def _scratch(mode: int, cores: int, ram_k: int) -> torch.Tensor | None:
    """The global walk's scratch where the kernel takes that walk."""
    if station_scan.walk_of(mode, cores, ram_k) != station_scan.WALK_GLOBAL:
        return None
    return torch.empty((SCAN_ROWS, cores + ram_k), dtype=torch.float32)


#: one server (Lindley's thread walk); the warp walk at the edges of its
#: width classes on the card (whole on every lane up to 4, then one, two
#: entries a lane), a carry of three; one core past the warp walk's widest
#: vector (the global walk)
WAIT_CORES = [1, 2, 3, 4, 5, 8, 9, 33, station_scan.WARP_WIDTH_MAX + 1]


@pytest.mark.parametrize("cores", WAIT_CORES)
def test_station_waits_match_plain(host_libs, cores: int) -> None:
    # rows of 3001: each row starts at another offset from a 16-byte boundary;
    # the widest station is loaded past its cores, so that it queues at all
    rate = (40.0 if cores <= station_scan.WARP_WIDTH_MAX else 200.0) * cores
    a, d, v = _stream(3, 3001, rate=rate, svc=0.02)
    out = torch.empty_like(a)
    mode = station_scan.MODE_LINDLEY if cores == 1 else station_scan.MODE_KW
    scratch = _scratch(mode, cores, 0)
    args = station_scan._StationArgs(
        a=a.data_ptr(), d=d.data_ptr(), v=v.data_ptr(), out0=out.data_ptr(),
        scratch=0 if scratch is None else scratch.data_ptr(),
        S=SCAN_ROWS, m=a.shape[1], mode=mode, cores=cores, ram_k=0,
    )
    _launch(host_libs["station_scan"], "station_scan_launch", args)
    want = (station_scan.lindley_plain(a, d, v) if cores == 1
            else station_scan.kw_plain(a, d, v, cores))
    assert torch.equal(out, want)
    assert float(want[v].max()) > 0.0


#: (RAM slots, cores): the slots at the edges of the warp walk's width
#: classes up to its widest vector, the earlier register and scratch cases
#: (3, 1), (5, 2), (32, 8), (20, 2), (70, 1), a core vector wider than the
#: slots, and one core vector past the warp walk (the global walk)
RAM_CASES = [(1, 1), (3, 1), (4, 4), (5, 2), (5, 5), (20, 2), (31, 1), (32, 8), (33, 2),
             (64, 1), (65, 9), (70, 1), (station_scan.WARP_WIDTH_MAX, 1), (20, 33),
             (8, station_scan.WARP_WIDTH_MAX + 1)]


@pytest.mark.parametrize(("ram_k", "cores"), RAM_CASES)
def test_ram_core_matches_plain(host_libs, ram_k: int, cores: int) -> None:
    a, d, v = _stream(4, 2501, rate=60.0, svc=0.01)
    g = np.random.default_rng(9)
    m = a.shape[1]
    pre = torch.tensor(np.full((SCAN_ROWS, m), 0.001, np.float32))
    # residence about 1.5x what the slots hold at the valid lanes' rate (two
    # thirds of 60 a second): admission binds
    post = torch.tensor(
        g.exponential(1.5 * ram_k / 40.0, (SCAN_ROWS, m)).astype(np.float32))
    d = torch.where(torch.tensor(g.random((SCAN_ROWS, m)) < 0.1), 0.0, d)  # IO-only lanes
    outs = [torch.empty_like(a) for _ in range(3)]
    scratch = _scratch(station_scan.MODE_RAM_CORE, cores, ram_k)
    args = station_scan._StationArgs(
        a=a.data_ptr(), d=d.data_ptr(), v=v.data_ptr(), pre=pre.data_ptr(),
        post=post.data_ptr(), out0=outs[0].data_ptr(), out1=outs[1].data_ptr(),
        out2=outs[2].data_ptr(), scratch=0 if scratch is None else scratch.data_ptr(),
        S=SCAN_ROWS, m=m, mode=station_scan.MODE_RAM_CORE, cores=cores, ram_k=ram_k,
    )
    _launch(host_libs["station_scan"], "station_scan_launch", args)
    want = station_scan.ram_core_plain(a, pre, d, post, v, ram_k, cores)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    assert float(want[0][v].max()) > 0.0


def test_wide_carry_needs_scratch(host_libs) -> None:
    """The library's width limits are the wrapper's: the warp walk holds
    carry vectors of up to WARP_WIDTH_MAX entries, each whole on every lane
    (one lane a row here), padded to a power of two; a wider vector takes
    the global walk, which is refused without its scratch.  The controlled
    mode takes the lane walk up to LANE_WHOLE ring entries and cores, the
    socket mode up to LANE_WHOLE connections besides, each refused on
    inputs off their boundaries, and else the warp walk (one core at a cap
    of 9 too); the bucket takes the warp walk."""
    lib = host_libs["station_scan"]
    for fn in ("station_scan_walk", "station_scan_lane_entries", "station_scan_lane_span",
               "station_scan_lanes", "station_scan_warp_width_max", "station_scan_lane_whole"):
        getattr(lib, fn).restype = ctypes.c_int
    top = station_scan.WARP_WIDTH_MAX
    assert lib.station_scan_warp_width_max() == top
    whole = station_scan.LANE_WHOLE
    assert lib.station_scan_lane_whole() == whole
    kw, ram, sock = station_scan.MODE_KW, station_scan.MODE_RAM_CORE, station_scan.MODE_SOCKET
    ctl = station_scan.MODE_CONTROLLED
    thread, warp, wide, lane = (station_scan.WALK_THREAD, station_scan.WALK_WARP,
                                station_scan.WALK_GLOBAL, station_scan.WALK_LANE)
    cases = [(station_scan.MODE_LINDLEY, 1, 0, -1, thread), (kw, 2, 0, -1, warp),
             (kw, top, 0, -1, warp), (kw, top + 1, 0, -1, wide), (ram, 1, 1, -1, warp),
             (ram, top, top, -1, warp), (ram, 1, top + 1, -1, wide), (ram, top + 1, 1, -1, wide),
             (station_scan.MODE_BUCKET, 1, 0, -1, warp), (sock, 1, 6, 4, lane),
             (sock, whole, whole, whole, lane), (sock, whole + 1, whole, whole, warp),
             (sock, 1, whole + 1, -1, warp), (sock, 1, 1, whole + 1, warp),
             (sock, top + 1, 6, 4, wide)]
    cases += [(ctl, cores, 0, cap, lane) for cores in range(1, whole + 1)
              for cap in (-1, 0, 1, whole)]
    cases += [(ctl, 1, 0, whole + 1, warp), (ctl, whole, 0, whole + 1, warp),
              (ctl, whole + 1, 0, -1, warp), (ctl, 1, 0, station_scan.RING_MAX, warp),
              (ctl, top, 0, whole, warp), (ctl, top + 1, 0, 1, wide)]
    for mode, cores, ram_k, cap, walk in cases:
        assert station_scan.walk_of(mode, cores, ram_k, cap) == walk
        assert lib.station_scan_walk(mode, cores, ram_k, cap) == walk
    lanes = lib.station_scan_lanes()
    assert lanes == 1
    for width in (1, 2, 3, 4, 5, 31, 32, 33, 64, 65, top):
        form = (lib.station_scan_lane_entries(width), lib.station_scan_lane_span(width))
        whole = (1 << (width - 1).bit_length(), 1)
        assert form == station_scan.carry_form(width, lanes) == whole
    # on the card's 32 lanes: whole up to WHOLE_MAX, then spread
    widths = (1, 3, 4, 5, 32, 33, 64, 65, 129, top)
    assert [station_scan.carry_form(w) for w in widths] == [
        (1, 1), (4, 1), (4, 1), (1, 32), (1, 32), (2, 32), (2, 32), (4, 32), (8, 32),
        (32, 32)]
    a, d, v = _stream(5, 64, rate=10.0, svc=0.01)
    out = torch.empty_like(a)
    args = station_scan._StationArgs(
        a=a.data_ptr(), d=d.data_ptr(), v=v.data_ptr(), pre=a.data_ptr(), post=a.data_ptr(),
        out0=out.data_ptr(), out1=out.data_ptr(), out2=out.data_ptr(), scratch=0,
        S=SCAN_ROWS, m=a.shape[1], mode=ram, cores=1, ram_k=top + 1,
    )
    assert lib.station_scan_launch(ctypes.byref(args), None) == -1
    a, e, d, post, b, v = _control_rows(12, 64, 1)
    flags = torch.empty(a.shape, dtype=torch.uint8)
    for mode in (sock, ctl):
        for shift_f, shift_b in ((4, 0), (0, 1)):
            args = station_scan._StationArgs(
                a=a.data_ptr() + shift_f, e=e.data_ptr(), d=d.data_ptr(), post=post.data_ptr(),
                b=b.data_ptr(), v=v.data_ptr() + shift_b, out0=out.data_ptr(),
                flag=flags.data_ptr(), S=SCAN_ROWS - 1, m=a.shape[1] - 1, mode=mode, cores=1,
                cap=4, conn=6, timeout=-1.0,
            )
            assert lib.station_scan_launch(ctypes.byref(args), None) == -1


#: duplicate breakpoints of the fault tables' "duplicates" form: before the
#: base row at each index, that many decoy rows at its time (a factor of 5
#: and a boost of 0.4 on every edge), which a lookup must never read: at a
#: duplicate time the last row holds
FAULT_DECOYS = {1: 1, 4: 2, 6: 1}


def _fault_tables(per_row: bool, duplicates: bool = False):
    """Edge fault tables over edges 0..3 on [0, 2.2): a partition of edge 1
    on [0.3, 0.7), degrades of edge 3 overlapping on [0.5, 1.1) and
    [0.9, 1.6) (factors multiply, boosts add), a degrade of edge 2 from
    t = 0; with ``duplicates``, decoy rows before three of the breakpoints
    at their times (``FAULT_DECOYS``); per scenario, each row's times
    shifted by 0.1 s a row (clipped at 0, the first row at 0)."""
    times = np.array([0.0, 0.3, 0.5, 0.7, 0.9, 1.1, 1.6], np.float32)
    lat = np.ones((7, 4), np.float32)
    boost = np.zeros((7, 4), np.float32)
    boost[1:3, 1] = 1.0
    lat[2:5, 3] *= 3.0
    boost[2:5, 3] += 0.2
    lat[4:6, 3] *= 1.5
    boost[4:6, 3] += 0.3
    lat[:, 2] = 2.0
    boost[:, 2] = 0.1
    if duplicates:
        rows = [(times[i], lat[i], boost[i]) for i in range(7)]
        for i in sorted(FAULT_DECOYS, reverse=True):
            decoy = (times[i], np.full(4, 5.0, np.float32), np.full(4, 0.4, np.float32))
            rows[i:i] = [decoy] * FAULT_DECOYS[i]
        times = np.array([r[0] for r in rows], np.float32)
        lat, boost = np.stack([r[1] for r in rows]), np.stack([r[2] for r in rows])
    if not per_row:
        return tuple(torch.tensor(x) for x in (times, lat, boost))
    nf = times.shape[0]
    shift = 0.1 * np.arange(S, dtype=np.float32)[:, None]
    rows = np.maximum(times[None, :] + shift, np.float32(0.0))
    rows[:, 0] = 0.0
    return (torch.tensor(rows), torch.tensor(np.broadcast_to(lat, (S, nf, 4)).copy()),
            torch.tensor(np.broadcast_to(boost, (S, nf, 4)).copy()))


#: (lanes, per_row, duplicates) of the fault hop's cases: each lane form on
#: shared and per-scenario tables, then the same with duplicate breakpoints
FAULT_CASES = [
    pytest.param(lanes, per_row, dup, id=f"{lanes}-{per_row}" + ("-duplicates" if dup else ""))
    for dup in (False, True) for per_row in (False, True)
    for lanes in ("edge", "rank", "slot_spikes")
]


@pytest.mark.parametrize(("lanes", "per_row", "duplicates"), FAULT_CASES)
def test_fault_hop_matches_plain(host_libs, per_row: bool, lanes: str,
                                 duplicates: bool) -> None:
    """The hop under edge fault windows (shared or a row a scenario, a
    partition, overlapping degrades, one from t = 0; with and without
    duplicate breakpoint times): the same checks as the plain hop's, and
    the partition drops every send.  Eight sends a breakpoint lie exactly
    on the scenario's own breakpoint times, so a lookup that read a decoy
    row, or the row before a breakpoint, would move their drops or delays."""
    keys = scenario_keys(15, S)
    uk, zk = draws.hop_keys(keys, 32)
    mean, var, drop = _edge_params()
    g = np.random.default_rng(6)
    t_send = torch.tensor(g.uniform(0.0, 2.2, (S, N)), dtype=torch.float32)
    alive = torch.tensor(g.random((S, N)) > 0.1)
    fault_t, fault_lat, fault_drop = _fault_tables(per_row, duplicates)
    nf = int(fault_t.shape[-1])
    on = fault_t.expand(S, nf) if not per_row else fault_t
    t_send[:, : 8 * nf] = on.repeat(1, 8)  # on the breakpoints
    lb = lanes != "edge"
    spike_t, spike_v = _spike_tables() if lanes == "slot_spikes" else (None, None)
    tables = draws.EdgeTables(
        dist=DIST, mean=mean, var=var, drop=drop, horizon=2.0,
        lb_edge=torch.tensor([3, 1, 2], dtype=torch.int32) if lb else None,
        lb_target=torch.tensor([0, 1, 2], dtype=torch.int32) if lb else None,
        spike_t=spike_t, spike_v=spike_v,
        fault_t=fault_t, fault_lat=fault_lat, fault_drop=fault_drop,
    )
    rank = torch.tensor(g.permuted(np.tile(np.arange(N), (S, 1)), axis=1), dtype=torch.int64)
    slot = torch.tensor(g.integers(0, 3, (S, N)), dtype=torch.int32)
    ptr = lambda x: 0 if x is None else x.data_ptr()  # noqa: E731
    for edge in ([None] if lb else range(4)):
        kw = ({"edge": edge} if not lb else {"rank": rank} if lanes == "rank"
              else {"slot": slot})
        want = draws.hop_plain(tables, t_send, alive, uk, zk, **kw)
        k_slots = 3 if lb else 1
        out = draws.HopOut(
            t_next=torch.empty((S, N), dtype=torch.float32),
            ok=torch.empty((S, N), dtype=torch.bool),
            target=torch.empty((S, N), dtype=torch.int32) if lb else None,
            span=torch.empty((S, k_slots), dtype=torch.float32),
            dropped=torch.empty(S, dtype=torch.int64),
        )
        partial = torch.empty((S, draws.lane_blocks(N), k_slots + 1), dtype=torch.float64)
        ukw, zkw, dist = draws.key_words(uk), draws.key_words(zk), torch.tensor(DIST)
        args = draws._EdgeDrawArgs(
            ukey=ukw.data_ptr(), zkey=zkw.data_ptr(), t_send=t_send.data_ptr(),
            alive=alive.data_ptr(), rank=ptr(kw.get("rank")), slot=ptr(kw.get("slot")),
            lb_edge=ptr(tables.lb_edge), lb_target=ptr(tables.lb_target),
            mean=mean.data_ptr(), var=var.data_ptr(), drop=drop.data_ptr(),
            dist=dist.data_ptr(), spike_t=ptr(spike_t), spike_v=ptr(spike_v),
            fault_t=fault_t.data_ptr(), fault_lat=fault_lat.data_ptr(),
            fault_drop=fault_drop.data_ptr(),
            out=out.t_next.data_ptr(), ok=out.ok.data_ptr(), target=ptr(out.target),
            partial=partial.data_ptr(), span=out.span.data_ptr(),
            dropped=out.dropped.data_ptr(), S=S, n=N, horizon=2.0, NE=4,
            NB=0 if spike_t is None else 3, K=k_slots, edge=-1 if lb else edge,
            mode=draws.MODE_HOP, NF=nf, fault_per_row=int(per_row),
        )
        _launch(host_libs["edge_draws"], "edge_draws_launch", args)
        assert torch.equal(out.ok, want.ok), edge
        assert torch.equal(out.dropped, want.dropped), edge
        if lb:
            assert torch.equal(out.target, want.target)
        assert _ulps(out.t_next, want.t_next) <= 4, edge
        assert _ulps(out.span, want.span) <= 1, edge
        if edge == 1:
            # the partition drops every send inside it
            idx = draws.fault_rows(fault_t, t_send)
            boost = (fault_drop[idx, 1] if not per_row
                     else fault_drop[:, :, 1].gather(1, idx))
            parted = alive & (t_send < 2.0) & (boost >= 1.0)
            assert bool(parted.any()) and not bool((want.ok & parted).any())


def _wide_fault_tables(nf: int, per_row: bool, seed: int):
    """``nf`` breakpoints on [0, 2.2) drawn on a grid of 1/512 s (so that
    many times repeat), the first at 0, with random factors in [0.5, 3) and
    boosts in [-0.1, 0.6) over four edges; per scenario when ``per_row``."""
    g = np.random.default_rng(seed)
    rows = S if per_row else 1
    times = np.sort(g.integers(0, 1127, (rows, nf)), axis=1).astype(np.float32) / 512
    times[:, 0] = 0.0
    lat = g.uniform(0.5, 3.0, (rows, nf, 4)).astype(np.float32)
    boost = g.uniform(-0.1, 0.6, (rows, nf, 4)).astype(np.float32)
    if not per_row:
        times, lat, boost = times[0], lat[0], boost[0]
    return tuple(torch.tensor(x) for x in (times, lat, boost))


#: breakpoints of the wide fault tables: a row whose tables the hop stages
#: in its 48 KiB of shared memory beside three slots' sums, and one past
#: all 48 KiB (its lanes read them in global memory)
WIDE_FAULTS = [pytest.param(300, False, id="staged"), pytest.param(20_000, True, id="global")]


@pytest.mark.parametrize(("nf", "per_row"), WIDE_FAULTS)
def test_wide_fault_tables_match_plain(host_libs, nf: int, per_row: bool) -> None:
    """The LB hop by rank under fault tables of hundreds and of tens of
    thousands of breakpoints, many at duplicate times, a send on every
    eighth breakpoint: the same outputs as the plain hop, whether its
    tables fit in shared memory or not."""
    uk, zk = draws.hop_keys(scenario_keys(16, S), 32)
    mean, var, drop = _edge_params()
    g = np.random.default_rng(7)
    t_send = torch.tensor(g.uniform(0.0, 2.2, (S, N)), dtype=torch.float32)
    alive = torch.tensor(g.random((S, N)) > 0.1)
    fault_t, fault_lat, fault_drop = _wide_fault_tables(nf, per_row, 8)
    on = fault_t.expand(S, nf)[:, ::8][:, : N // 2]
    t_send[:, : on.shape[1]] = on  # on the breakpoints
    rank = torch.tensor(g.permuted(np.tile(np.arange(N), (S, 1)), axis=1), dtype=torch.int64)
    tables = draws.EdgeTables(
        dist=DIST, mean=mean, var=var, drop=drop, horizon=2.0,
        lb_edge=torch.tensor([3, 1, 2], dtype=torch.int32),
        lb_target=torch.tensor([0, 1, 2], dtype=torch.int32),
        fault_t=fault_t, fault_lat=fault_lat, fault_drop=fault_drop,
    )
    want = draws.hop_plain(tables, t_send, alive, uk, zk, rank=rank)
    out = draws.HopOut(
        t_next=torch.empty((S, N), dtype=torch.float32),
        ok=torch.empty((S, N), dtype=torch.bool),
        target=torch.empty((S, N), dtype=torch.int32),
        span=torch.empty((S, 3), dtype=torch.float32),
        dropped=torch.empty(S, dtype=torch.int64),
    )
    partial = torch.empty((S, draws.lane_blocks(N), 4), dtype=torch.float64)
    ukw, zkw, dist = draws.key_words(uk), draws.key_words(zk), torch.tensor(DIST)
    args = draws._EdgeDrawArgs(
        ukey=ukw.data_ptr(), zkey=zkw.data_ptr(), t_send=t_send.data_ptr(),
        alive=alive.data_ptr(), rank=rank.data_ptr(), lb_edge=tables.lb_edge.data_ptr(),
        lb_target=tables.lb_target.data_ptr(), mean=mean.data_ptr(), var=var.data_ptr(),
        drop=drop.data_ptr(), dist=dist.data_ptr(), fault_t=fault_t.data_ptr(),
        fault_lat=fault_lat.data_ptr(), fault_drop=fault_drop.data_ptr(),
        out=out.t_next.data_ptr(), ok=out.ok.data_ptr(), target=out.target.data_ptr(),
        partial=partial.data_ptr(), span=out.span.data_ptr(), dropped=out.dropped.data_ptr(),
        S=S, n=N, horizon=2.0, NE=4, K=3, edge=-1, mode=draws.MODE_HOP, NF=nf,
        fault_per_row=int(per_row),
    )
    _launch(host_libs["edge_draws"], "edge_draws_launch", args)
    assert torch.equal(out.ok, want.ok)
    assert torch.equal(out.dropped, want.dropped)
    assert torch.equal(out.target, want.target)
    assert _ulps(out.t_next, want.t_next) <= 4
    assert _ulps(out.span, want.span) <= 1


@pytest.mark.parametrize(("rate", "burst"), [(5.0, 50.0), (0.37, 3.0), (100.0, 1.0),
                                             (0.0, 2.0)])
def test_bucket_matches_plain(host_libs, rate: float, burst: float) -> None:
    """The token-bucket mode on sorted rows of 4099 elements (a third
    invalid, runs of equal times), exactly."""
    g = np.random.default_rng(7)
    t = np.cumsum(g.exponential(1.0 / (1.3 * rate + 1.0), (S, N)), axis=1).astype(np.float32)
    t[:, 100:110] = t[:, 100:101]
    v = torch.tensor(g.random((S, N)) < 0.7)
    t = torch.tensor(np.where(v.numpy(), t, np.float32(1e30)))
    flag = torch.empty((S, N), dtype=torch.bool)
    args = station_scan._StationArgs(a=t.data_ptr(), v=v.data_ptr(), flag=flag.data_ptr(),
                                     S=S, m=N, mode=station_scan.MODE_BUCKET, cores=1,
                                     rate=rate, burst=burst)
    _launch(host_libs["station_scan"], "station_scan_launch", args)
    want = station_scan.token_bucket_plain(t, v, rate, burst)
    assert torch.equal(flag, want)
    assert bool(want.any()) and bool((v & ~want).any())  # the bucket accepts and refuses


#: row layouts of the bucket's warp walk: the valid elements first and an
#: invalid tail of each row's own length (as the fast path sorts a server's
#: arrivals for its rate limit), and ~5% of the elements valid (a retry
#: pass's wants among its lanes)
BUCKET_LAYOUTS = {"sorted_tail": 0.6, "sparse": 0.05}


@pytest.mark.parametrize("layout", sorted(BUCKET_LAYOUTS))
def test_bucket_layouts_match_plain(host_libs, layout: str) -> None:
    """The token bucket on sorted rows of 4099 in each layout, the valid
    elements arriving at 1.3x the refill rate (a bucket of 3 at 5 a
    second), exactly."""
    rate, burst, share = 5.0, 3.0, BUCKET_LAYOUTS[layout]
    g = np.random.default_rng(17)
    t = np.cumsum(g.exponential(share / (1.3 * rate), (S, N)), axis=1).astype(np.float32)
    if layout == "sorted_tail":
        v = np.arange(N)[None, :] < g.integers(N // 3, N, (S, 1))
    else:
        v = g.random((S, N)) < share
    v = torch.tensor(v)
    t = torch.tensor(np.where(v.numpy(), t, np.float32(1e30)))
    flag = torch.empty((S, N), dtype=torch.bool)
    args = station_scan._StationArgs(a=t.data_ptr(), v=v.data_ptr(), flag=flag.data_ptr(),
                                     S=S, m=N, mode=station_scan.MODE_BUCKET, cores=1,
                                     rate=rate, burst=burst)
    _launch(host_libs["station_scan"], "station_scan_launch", args)
    want = station_scan.token_bucket_plain(t, v, rate, burst)
    assert torch.equal(flag, want)
    assert bool(want.any()) and bool((v & ~want).any())


def _control_rows(seed: int, m: int, cores: int):
    """(arrival, enqueue, service, post-IO, burst, valid) (SCAN_ROWS, m):
    arrivals at 1.3x the cores' service rate, a third invalid, a tenth
    io-only, each row's tail padded INF, a 3 ms pre-IO a burst."""
    a, d, v = _stream(seed, m, rate=52.0 * cores / 0.67, svc=0.025)
    g = np.random.default_rng(seed + 1)
    b = v & torch.tensor(g.random(a.shape) < 0.9)
    e = torch.where(v, a + np.float32(0.003), 1e30)
    post = torch.tensor(g.exponential(0.05, a.shape).astype(np.float32))
    return a, e, d, post, b, v


#: (cores, cap, timeout) of the controlled mode: the lane walk (cores and
#: cap up to LANE_WHOLE), the warp walk at the card's width classes (and at
#: the widest ring), the global walk with the ring in shared memory; the
#: ring's edges (none, 1 entry, 128) and a deadline
CONTROLLED_CASES = [(cores, cap, timeout)
                    for cores in (1, 2, 5, 33, station_scan.WARP_WIDTH_MAX + 1)
                    for cap, timeout in ((-1, 0.05), (1, -1.0), (8, 0.05), (128, -1.0))]


@pytest.mark.parametrize(("cores", "cap", "timeout"), CONTROLLED_CASES)
def test_controlled_matches_plain(host_libs, cores: int, cap: int, timeout: float) -> None:
    _a, e, d, _post, b, _v = _control_rows(11, 1001, min(cores, 40))
    e = torch.where(b, e, 1e30)
    wait = torch.empty_like(e)
    flags = torch.empty(e.shape, dtype=torch.uint8)
    scratch = _scratch(station_scan.MODE_CONTROLLED, cores, 0)
    args = station_scan._StationArgs(
        a=e.data_ptr(), d=d.data_ptr(), v=b.data_ptr(), out0=wait.data_ptr(),
        flag=flags.data_ptr(), scratch=0 if scratch is None else scratch.data_ptr(),
        S=SCAN_ROWS, m=e.shape[1], mode=station_scan.MODE_CONTROLLED, cores=cores, cap=cap,
        timeout=timeout,
    )
    _launch(host_libs["station_scan"], "station_scan_launch", args)
    want = station_scan.controlled_plain(e, d, b, cores, cap, timeout)
    assert torch.equal(wait, want[0]) and torch.equal(flags, want[1])
    if cores <= 33 and cap >= 0 and cap < 128:
        assert bool((want[1] & station_scan.FLAG_SHED).any())


@pytest.mark.parametrize("timeout", [-1.0, 0.05])
@pytest.mark.parametrize("cap", [-1, 0, 1, station_scan.LANE_WHOLE])
@pytest.mark.parametrize("cores", [1, 2, station_scan.LANE_WHOLE])
def test_controlled_lane_walk_matches_plain(host_libs, cores: int, cap: int,
                                            timeout: float) -> None:
    """The controlled mode's lane walk over its shapes (cores and cap up to
    LANE_WHOLE, a deadline or none) on rows of 1001 (each starts at another
    offset from a 16-byte boundary), bit for bit."""
    assert station_scan.walk_of(station_scan.MODE_CONTROLLED, cores, 0, cap) \
        == station_scan.WALK_LANE
    _a, e, d, _post, b, _v = _control_rows(15, 1001, cores)
    e = torch.where(b, e, 1e30)
    wait = torch.empty_like(e)
    flags = torch.empty(e.shape, dtype=torch.uint8)
    args = station_scan._StationArgs(
        a=e.data_ptr(), d=d.data_ptr(), v=b.data_ptr(), out0=wait.data_ptr(),
        flag=flags.data_ptr(), S=SCAN_ROWS, m=e.shape[1], mode=station_scan.MODE_CONTROLLED,
        cores=cores, cap=cap, timeout=timeout,
    )
    _launch(host_libs["station_scan"], "station_scan_launch", args)
    want = station_scan.controlled_plain(e, d, b, cores, cap, timeout)
    assert torch.equal(wait, want[0]) and torch.equal(flags, want[1])
    bits = (station_scan.FLAG_SHED if cap >= 0 else 0) \
        | (station_scan.FLAG_ABANDONED if timeout >= 0 else 0)
    assert int(want[1].max()) > 0 if bits else not bool(want[1].any())
    assert not bool((want[1] & ~torch.tensor(bits, dtype=torch.uint8)).any())


#: (cores, connections) of the socket mode: the warp walk with the cores
#: whole on every lane or spread (the connections in their one form), and
#: the global walk
SOCKET_CASES = [(cores, conn) for cores in (1, 2, 33, station_scan.WARP_WIDTH_MAX + 1)
                for conn in (1, 5, 33, station_scan.RING_MAX)]


@pytest.mark.parametrize(("cap", "timeout"), [(-1, -1.0), (4, 0.05)])
@pytest.mark.parametrize(("cores", "conn"), SOCKET_CASES)
def test_socket_matches_plain(host_libs, cores: int, conn: int, cap: int,
                              timeout: float) -> None:
    a, e, d, post, b, v = _control_rows(12, 1001, min(cores, 40))
    wait = torch.empty_like(a)
    flags = torch.empty(a.shape, dtype=torch.uint8)
    scratch = _scratch(station_scan.MODE_SOCKET, cores, conn)
    args = station_scan._StationArgs(
        a=a.data_ptr(), e=e.data_ptr(), d=d.data_ptr(), post=post.data_ptr(),
        b=b.data_ptr(), v=v.data_ptr(), out0=wait.data_ptr(), flag=flags.data_ptr(),
        scratch=0 if scratch is None else scratch.data_ptr(), S=SCAN_ROWS, m=a.shape[1],
        mode=station_scan.MODE_SOCKET, cores=cores, cap=cap, conn=conn, timeout=timeout,
    )
    _launch(host_libs["station_scan"], "station_scan_launch", args)
    want = station_scan.socket_plain(a, e, d, post, b, v, cores, conn, cap, timeout)
    assert torch.equal(wait, want[0]) and torch.equal(flags, want[1])
    if conn <= cores + 4:
        assert bool((want[1] & station_scan.FLAG_REFUSED).any())


#: (cores, connections, cap) at the edges of the socket scan's lane walk:
#: LANE_WHOLE of each, and one past the connections, the cap or the cores
#: (the warp walk)
SOCKET_EDGES = [(cores, conn, cap) for cores in (1, 2) for conn, cap in ((8, 8), (9, 8), (8, 9))]
SOCKET_EDGES += [(8, 8, 8), (9, 6, 4)]


@pytest.mark.parametrize(("cores", "conn", "cap"), SOCKET_EDGES)
def test_socket_edges_match_plain(host_libs, cores: int, conn: int, cap: int) -> None:
    a, e, d, post, b, v = _control_rows(13, 1001, cores)
    wait = torch.empty_like(a)
    flags = torch.empty(a.shape, dtype=torch.uint8)
    args = station_scan._StationArgs(
        a=a.data_ptr(), e=e.data_ptr(), d=d.data_ptr(), post=post.data_ptr(),
        b=b.data_ptr(), v=v.data_ptr(), out0=wait.data_ptr(), flag=flags.data_ptr(),
        S=SCAN_ROWS, m=a.shape[1], mode=station_scan.MODE_SOCKET, cores=cores, cap=cap,
        conn=conn, timeout=0.05,
    )
    _launch(host_libs["station_scan"], "station_scan_launch", args)
    want = station_scan.socket_plain(a, e, d, post, b, v, cores, conn, cap, 0.05)
    assert torch.equal(wait, want[0]) and torch.equal(flags, want[1])
    assert bool(want[1].any())  # a control binds


#: (LB slots, ring, marks (time, down, slot)) of least connections: the
#: mixed fleet's two slots and ring of 23, a timeline with marks at one time
#: and every slot down a while, five slots, the widest (32 slots, rings of
#: 128), rings of exactly one warp's lanes and one past it (the card's
#: layout's edges), four slots on rings of 3 whose deliveries outlast the
#: row, so that every slot's count saturates and ties (the pick falls to
#: the rotation's order), two slots on rings of 4 with ~10 deliveries in
#: flight a slot: the rings are mostly full of live entries, so that the
#: smallest must be replaced, and two slots on rings of 1, which the host
#: build's one lane a warp holds in the registers form
LC_CASES = {
    "two_slots": (2, 23, []),
    "timeline": (3, 5, [(2.0, 1, 0), (4.0, 1, 1), (4.0, 1, 2), (6.0, 0, 1), (6.0, 0, 0),
                        (9.0, 1, 1)]),
    "five_slots": (5, 40, [(1.0, 1, 3)]),
    "widest": (routing.MAX_LC_SLOTS, routing.MAX_LC_RING, [(3.0, 1, 0)]),
    "ring_32": (2, 32, []),
    "ring_33": (2, 33, []),
    "tied": (4, 3, [(5.0, 1, 2), (7.0, 0, 2)]),
    "full": (2, 4, []),
    "ring_1": (2, 1, []),
}
#: the spread of a case's candidate delays (default 0.005 s x the ring)
LC_DELAY = {"tied": 50.0, "full": 0.3, "ring_1": 0.02}


@pytest.mark.parametrize("name", sorted(LC_CASES))
def test_lc_matches_plain(host_libs, name: str) -> None:
    el, ring, marks = LC_CASES[name]
    g = torch.Generator().manual_seed(1)
    rows, n = 3, 1501
    t = torch.sort(torch.rand(rows, n, generator=g) * 10, dim=1).values
    ok = torch.rand(rows, n, generator=g) < 0.9
    order = torch.sort((~ok).int(), dim=1, stable=True).indices  # dead lanes last
    ok = ok.gather(1, order)
    t = torch.where(ok, t.gather(1, order), 1e30)
    delay = LC_DELAY.get(name, 0.005 * ring)
    deliv = t[..., None] + torch.rand(rows, n, el, generator=g) * delay
    drop = torch.rand(rows, n, el, generator=g) < 0.1
    tl = routing.Timeline([m[0] for m in marks], [m[1] for m in marks],
                          [m[2] for m in marks], el, "cpu")
    out = torch.empty((rows, n), dtype=torch.int32)
    args = routing._LbRouteArgs(S=rows, n=n, NTL=tl.n_marks, EL=el, mode=routing.MODE_LC,
                                R=ring)
    tensors = {"t": t, "alive": ok, "deliv": deliv, "drop": drop, "slot": out,
               "tl_time": tl.times, "tl_down": tl.down, "tl_slot": tl.slot}
    for key, x in tensors.items():
        if x.numel():
            setattr(args, key, x.data_ptr())
    _launch(host_libs["lb_route"], "lb_route_launch", args)
    want = routing.PlainLbRoute().lc(tl, t, ok, deliv, drop, ring)
    assert torch.equal(out, want)
    # only the timeline with every slot down leaves an alive lane unrouted;
    # every slot takes traffic
    assert bool((want[ok] < 0).any()) == (name == "timeline")
    assert set(range(el)) <= set(want[ok].tolist())


#: least connections' candidate edges of each slot count: every law among them
CANDIDATE_EDGES = {1: [3], 2: [0, 1], 3: [3, 1, 2]}
#: the candidates' fault tables: none, a shared table staged in shared
#: memory, and a table a scenario past it (read in global memory)
CANDIDATE_FAULTS = ["none", "staged", "global"]


@pytest.mark.parametrize("faults", CANDIDATE_FAULTS)
@pytest.mark.parametrize("spikes", [False, True])
@pytest.mark.parametrize("slots", sorted(CANDIDATE_EDGES))
def test_candidates_match_plain(host_libs, slots: int, spikes: bool, faults: str) -> None:
    """Least connections' candidates in one launch: each slot's hop over
    its own edge with its own keys, written (S, n, slots), against the plain
    version's stack of hops without sums: ``ok`` exact, ``t_next`` within
    4 ulps (the delays' libm rounding)."""
    mean, var, drop = _edge_params()
    keys = scenario_keys(4, S)
    g = np.random.default_rng(3)
    t = torch.tensor(g.uniform(0.0, 2.2, (S, N)).astype(np.float32))
    alive = torch.tensor(g.random((S, N)) < 0.9)
    edges = CANDIDATE_EDGES[slots]
    spike_t, spike_v = _spike_tables() if spikes else (None, None)
    fault = {"none": (None, None, None), "staged": _fault_tables(per_row=False),
             "global": _wide_fault_tables(20_000, True, 9)}[faults]
    if faults == "staged":
        t[:, :56] = fault[0].repeat(8)  # sends on the breakpoints
    tables = draws.EdgeTables(dist=DIST, mean=mean, var=var, drop=drop, horizon=2.0,
                              spike_t=spike_t, spike_v=spike_v, fault_t=fault[0],
                              fault_lat=fault[1], fault_drop=fault[2])
    uk, zk = (torch.stack(x, dim=1) for x in zip(*(draws.hop_keys(keys, 32 + k)
                                                   for k in range(slots))))
    want = draws.candidates_plain(tables, t, alive, uk, zk, edges)
    out = torch.empty((S, N, slots), dtype=torch.float32)
    ok = torch.empty((S, N, slots), dtype=torch.bool)
    ukw, zkw, dist = draws.key_words(uk), draws.key_words(zk), torch.tensor(DIST)
    lb_edge = torch.tensor(edges, dtype=torch.int32)
    ptr = lambda x: 0 if x is None else x.data_ptr()  # noqa: E731
    nf = 0 if fault[0] is None else int(fault[0].shape[-1])
    args = draws._EdgeDrawArgs(
        ukey=ukw.data_ptr(), zkey=zkw.data_ptr(), t_send=t.data_ptr(), alive=alive.data_ptr(),
        lb_edge=lb_edge.data_ptr(), mean=mean.data_ptr(), var=var.data_ptr(),
        drop=drop.data_ptr(), dist=dist.data_ptr(), spike_t=ptr(spike_t), spike_v=ptr(spike_v),
        fault_t=ptr(fault[0]), fault_lat=ptr(fault[1]), fault_drop=ptr(fault[2]),
        out=out.data_ptr(), ok=ok.data_ptr(), S=S, n=N, horizon=2.0, NE=4,
        NB=0 if spike_t is None else 3, K=slots, edge=-1, mode=draws.MODE_CANDIDATES, NF=nf,
        fault_per_row=int(faults == "global"),
    )
    _launch(host_libs["edge_draws"], "edge_draws_launch", args)
    assert torch.equal(ok, want[1])
    assert _ulps(out, want[0]) <= 4
    # every slot sends lanes; some gated lanes are dropped
    assert bool(ok.any(dim=(0, 1)).all())
    assert bool(((alive & (t < 2.0))[..., None] & ~ok).any())


def _wide_spike_tables(nb: int, seed: int):
    """``nb`` spike breakpoints on [0, 2.2) drawn on a grid of 1/512 s (so
    that many times repeat), the first at 0, with spikes in [0, 0.5) on
    every edge."""
    g = np.random.default_rng(seed)
    times = np.sort(g.integers(0, 1127, nb)).astype(np.float32) / 512
    times[0] = 0.0
    spike_v = g.uniform(0.0, 0.5, (nb, 4)).astype(np.float32)
    return torch.tensor(times), torch.tensor(spike_v)


#: (lanes, spike breakpoints, fault breakpoints, lanes a row) of the wide
#: spike tables' cases, each placed in the hop's 48 KiB of shared memory as
#: named: the LB hop by slot (three slots) with its spikes staged, with its
#: spikes in global memory, and with its spikes staged pushing 300 shared
#: fault breakpoints into global memory; the static hop and the candidates
#: (two slots) with their spikes in global memory, and staged pushing the
#: fault tables out; the last on rows of a multiple of 4 lanes (the static
#: hop's consecutive lanes a thread)
WIDE_SPIKES = [
    pytest.param("slot", 300, 0, N, id="slot-staged"),
    pytest.param("slot", 6000, 0, N, id="slot-global"),
    pytest.param("slot", 2000, 300, N, id="slot-staged-faults_global"),
    pytest.param("edge", 6000, 0, N, id="static-global"),
    pytest.param("edge", 3500, 300, N, id="static-staged-faults_global"),
    pytest.param("candidates", 6000, 0, N, id="candidates-global"),
    pytest.param("candidates", 3500, 300, N, id="candidates-staged-faults_global"),
    pytest.param("edge", 3500, 300, 4100, id="static-consecutive-staged-faults_global"),
]


@pytest.mark.parametrize(("lanes", "nb", "nf", "n"), WIDE_SPIKES)
def test_wide_spike_tables_match_plain(host_libs, lanes: str, nb: int, nf: int, n: int) -> None:
    """The hop by slot, the static hop and the candidates under spike
    tables of hundreds and of thousands of breakpoints, many at duplicate
    times, a send on every eighth breakpoint (so that a search that took
    the row before a breakpoint, or one of its duplicates, would move their
    delays), with and without fault tables beside them: the same outputs
    as the plain version, wherever the tables lie."""
    N = n  # noqa: N806 - the module's name for the shape
    uk, zk = draws.hop_keys(scenario_keys(17, S), 32)
    mean, var, drop = _edge_params()
    g = np.random.default_rng(10)
    t_send = torch.tensor(g.uniform(0.0, 2.2, (S, N)), dtype=torch.float32)
    alive = torch.tensor(g.random((S, N)) > 0.1)
    spike_t, spike_v = _wide_spike_tables(nb, 11)
    on = spike_t[::8][: N // 2]
    t_send[:, : on.shape[0]] = on  # on the breakpoints
    fault = _wide_fault_tables(nf, False, 12) if nf else (None, None, None)
    slot = torch.tensor(np.where(g.random((S, N)) < 0.1, -1, g.integers(0, 3, (S, N))),
                        dtype=torch.int32)
    lb = lanes == "slot"
    tables = draws.EdgeTables(
        dist=DIST, mean=mean, var=var, drop=drop, horizon=2.0,
        lb_edge=torch.tensor([3, 1, 2], dtype=torch.int32) if lb else None,
        lb_target=torch.tensor([0, 1, 2], dtype=torch.int32) if lb else None,
        spike_t=spike_t, spike_v=spike_v,
        fault_t=fault[0], fault_lat=fault[1], fault_drop=fault[2],
    )
    ptr = lambda x: 0 if x is None else x.data_ptr()  # noqa: E731
    dist = torch.tensor(DIST)
    common = {"mean": mean.data_ptr(), "var": var.data_ptr(), "drop": drop.data_ptr(),
              "dist": dist.data_ptr(), "t_send": t_send.data_ptr(), "alive": alive.data_ptr(),
              "spike_t": spike_t.data_ptr(), "spike_v": spike_v.data_ptr(),
              "fault_t": ptr(fault[0]), "fault_lat": ptr(fault[1]),
              "fault_drop": ptr(fault[2]), "S": S, "n": N, "horizon": 2.0, "NE": 4, "NB": nb,
              "NF": nf}
    if lanes == "candidates":
        edges = [3, 1]
        uks, zks = (torch.stack(x, dim=1) for x in zip(*(draws.hop_keys(
            scenario_keys(17, S), 32 + k) for k in range(2))))
        want = draws.candidates_plain(tables, t_send, alive, uks, zks, edges)
        out = torch.empty((S, N, 2), dtype=torch.float32)
        ok = torch.empty((S, N, 2), dtype=torch.bool)
        ukw, zkw = draws.key_words(uks), draws.key_words(zks)
        lb_edge = torch.tensor(edges, dtype=torch.int32)
        args = draws._EdgeDrawArgs(
            ukey=ukw.data_ptr(), zkey=zkw.data_ptr(), lb_edge=lb_edge.data_ptr(),
            out=out.data_ptr(), ok=ok.data_ptr(), K=2, edge=-1, mode=draws.MODE_CANDIDATES,
            **common)
        _launch(host_libs["edge_draws"], "edge_draws_launch", args)
        assert torch.equal(ok, want[1])
        assert _ulps(out, want[0]) <= 4
        return
    k_slots = 3 if lb else 1
    for edge in ([None] if lb else [1, 3]):
        kw = {"slot": slot} if lb else {"edge": edge}
        want = draws.hop_plain(tables, t_send, alive, uk, zk, **kw)
        out = draws.HopOut(
            t_next=torch.empty((S, N), dtype=torch.float32),
            ok=torch.empty((S, N), dtype=torch.bool),
            target=torch.empty((S, N), dtype=torch.int32) if lb else None,
            span=torch.empty((S, k_slots), dtype=torch.float32),
            dropped=torch.empty(S, dtype=torch.int64),
        )
        partial = torch.empty((S, draws.lane_blocks(N), k_slots + 1), dtype=torch.float64)
        ukw, zkw = draws.key_words(uk), draws.key_words(zk)
        args = draws._EdgeDrawArgs(
            ukey=ukw.data_ptr(), zkey=zkw.data_ptr(), slot=ptr(kw.get("slot")),
            lb_edge=ptr(tables.lb_edge), lb_target=ptr(tables.lb_target),
            out=out.t_next.data_ptr(), ok=out.ok.data_ptr(), target=ptr(out.target),
            partial=partial.data_ptr(), span=out.span.data_ptr(),
            dropped=out.dropped.data_ptr(), K=k_slots, edge=-1 if lb else edge,
            mode=draws.MODE_HOP, **common)
        _launch(host_libs["edge_draws"], "edge_draws_launch", args)
        assert torch.equal(out.ok, want.ok), edge
        assert torch.equal(out.dropped, want.dropped), edge
        if lb:
            assert torch.equal(out.target, want.target)
        assert _ulps(out.t_next, want.t_next) <= 4, edge
        gate = alive & (t_send < 2.0)
        pick = torch.where(gate & (slot >= 0), slot.long(), 0) if lb else None
        assert torch.equal(out.span, _own_spans(out, t_send, pick, k_slots)), edge
        assert _ulps(out.span, want.span) <= 1, edge


def test_a_found_build_reports_its_ptxas_log(tmp_path, monkeypatch) -> None:
    """A library found built with its ptxas log beside it is not rebuilt
    and reports that log, as a fresh build does; one without its log is
    built again."""

    class Rebuilt(Exception):
        pass

    def nvcc_path() -> str:
        raise Rebuilt

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "ptxas_report", {})
    monkeypatch.setattr(_build, "nvcc_path", nvcc_path)
    target = _build.library_path("lb_route")
    target.write_bytes(b"")
    log = "ptxas info    : Used 40 registers, 0 bytes spill stores, 0 bytes spill loads\n"
    target.with_suffix(".ptxas").write_text(log)
    assert _build.build(["lb_route"]) == {"lb_route": target}
    assert _build.ptxas_report == {"lb_route": log}
    target.with_suffix(".ptxas").unlink()
    with pytest.raises(Rebuilt):
        _build.build(["lb_route"])


#: (rows of the grid, lanes a row, per-lane amounts) of the gauge grid's
#: checks: a stride grid in shared memory, the largest one there, and fine
#: grids past it (the global form), with +-1 and whole-MB amounts
GAUGE_CASES = [(61, 4099, False), (2048, 517, True), (2049, 517, False), (3001, 4099, True)]


@pytest.mark.parametrize(("rows", "n", "per_lane"), GAUGE_CASES)
def test_gauge_grid_matches_plain(host_libs, rows: int, n: int, per_lane: bool) -> None:
    """One gauge site's intervals into column 2 of a (S, rows, 4) grid that
    already holds other sites' adds: bit-exact with the plain scatter
    (sums of whole amounts), the other columns untouched; intervals
    past the horizon land in the last row."""
    lib = host_libs["gauge_grid"]
    g = torch.Generator().manual_seed(rows + n)
    period = 0.05
    span = period * rows
    t0 = torch.rand((S, n), generator=g) * span
    t1 = t0 + torch.rand((S, n), generator=g) * 2.0
    t1[:, ::7] = 1e30
    on = torch.rand((S, n), generator=g) > 0.25
    amount = (torch.randint(1, 300, (S, n), generator=g).float() if per_lane
              else torch.tensor(1.0))
    base = torch.randint(-3, 4, (S, rows, 4), generator=g).float()
    got = base.clone()
    args = gauge_grid._GaugeGridArgs(
        t0=t0.data_ptr(), t1=t1.data_ptr(), on=on.data_ptr(),
        amount=amount.data_ptr() if per_lane else None, grid=got.data_ptr(), S=S, n=n,
        rows=rows, G=4, col=2, scale=gauge_grid.bucket_scale(period),
        amount_scalar=0.0 if per_lane else 1.0)
    _launch(lib, "gauge_grid_launch", args)
    want = base.clone()
    gauge_grid.gauge_add_plain(want, 2, t0, t1, on, amount, period)
    assert torch.equal(got, want)
    assert torch.equal(got[:, :, [0, 1, 3]], base[:, :, [0, 1, 3]])
    assert lib.gauge_grid_shared_rows() == 2048
