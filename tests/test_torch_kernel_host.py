"""The CUDA kernel's source, compiled for the host CPU, against its twin.

``csrc/des_kernel.cu`` is plain C++ apart from CUDA's qualifiers, its thread
indices and the launch.  Built with g++ through a small shim header that
defines those away (the launch becomes a loop over blocks and threads), the
same source runs here and is held to the twin on the CPU, through the
wrapper's own argument packing (``des_kernel.pack_args``).  This checks the
kernel's logic and its argument layout, not the CUDA compiler: the card's
build is held to the twin by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Both sides evaluate float32 one operation at a time
(``-ffp-contract=off``), but glibc's ``logf`` and torch's may round a value
differently, so the tolerance is slice 1's: integer outputs equal in at
least S - 1 of S scenarios and pooled within 1, float moments within rtol
1e-4.  Agreement seen when this was written: every integer output equal in
every scenario, float moments within 4e-6 absolute.  Skipped where no g++
is installed.
"""

from __future__ import annotations

import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_cuda import (
    POOL_CASES,
    WORKLOAD_CASES,
    _controls_breaker,
    _event_inj,
    _events_and_controls,
    _lc_mixed,
    _payload,
)
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    one_torch_thread,
    torch_inference_mode,
)

from asyncflow_tpu_torch.compiler import compile_payload
from asyncflow_tpu_torch.engines.torchsim import des_kernel
from asyncflow_tpu_torch.engines.torchsim.des_reference import des_reference
from asyncflow_tpu_torch.engines.torchsim.kernel_engine import KernelEngine
from asyncflow_tpu_torch.engines.torchsim.keys import scenario_keys
from asyncflow_tpu_torch.schemas import SimulationPayload

one_torch_thread()

SOURCE = Path(des_kernel.__file__).resolve().parents[2] / "csrc" / "des_kernel.cu"
S = 16

#: what CUDA provides that the host lacks
SHIM = """
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
using std::max;
using std::min;
#define __device__
#define __host__
#define __forceinline__ inline
#define __global__
#define __shared__
#define __launch_bounds__(...)
struct HostDim { unsigned x; };
static HostDim blockIdx, blockDim, threadIdx;
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return 0;
}
// one lane: the warp's collectives are the lane's own values
inline void __syncwarp(unsigned = 0xffffffffu) {}
template <class T> inline T __shfl_sync(unsigned, T v, int) { return v; }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int) { return v; }
inline unsigned __ballot_sync(unsigned, int p) { return p ? 1u : 0u; }
template <class T> inline T __reduce_min_sync(unsigned, T v) { return v; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline float __int_as_float(int x) { float f; std::memcpy(&f, &x, 4); return f; }
inline int __float_as_int(float f) { int x; std::memcpy(&x, &f, 4); return x; }
inline unsigned __float_as_uint(float f) { unsigned x; std::memcpy(&x, &f, 4); return x; }
inline float __uint_as_float(unsigned x) { float f; std::memcpy(&f, &x, 4); return f; }
// a block's dynamic shared memory (227 KB at most): blocks run one at a time
int32_t des_smem[232448 / 4];
"""
LAUNCH = re.compile(
    r"des_kernel<kEvents, kControls, kWorkload><<<blocks, threads, lay.shared_bytes, stream>>>"
    r"\(args\);",
)
HOST_LAUNCH = (
    "for (unsigned b = 0; b < (unsigned)blocks; ++b)"
    " for (unsigned t = 0; t < (unsigned)threads; ++t) {"
    " blockIdx.x = b; blockDim.x = threads; threadIdx.x = t;"
    " des_kernel<kEvents, kControls, kWorkload>(args); }"
)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory) -> dict[bool, ctypes.CDLL]:
    """The two builds of the source (without and with the workload group),
    by whether they hold the workload instances; g++ builds them in
    parallel, as the card's build runs one nvcc for each."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    src = SOURCE.read_text()
    assert "#include <cuda_runtime.h>" in src
    assert LAUNCH.search(src), "the launch statement changed: update LAUNCH"
    src = LAUNCH.sub(HOST_LAUNCH, src.replace("#include <cuda_runtime.h>", '#include "shim.h"'))
    work = tmp_path_factory.mktemp("host_kernel")
    (work / "shim.h").write_text(SHIM)
    (work / "des_kernel.cpp").write_text(src)
    procs = {}
    for workload in (False, True):
        lib = work / f"libdes_kernel_host_{int(workload)}.so"
        procs[workload] = (lib, subprocess.Popen(  # noqa: S603 - fixed argv
            [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fno-strict-aliasing", "-shared",
             "-fPIC",
             f"-DDES_WORKLOAD={int(workload)}", "-o", str(lib),
             str(work / "des_kernel.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    hosts = {}
    for workload, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log
        host = des_kernel.bind(ctypes.CDLL(str(lib)))
        assert host.des_args_size() == ctypes.sizeof(des_kernel._DesArgs)
        assert host.des_workload() == int(workload)
        hosts[workload] = host
    return hosts


CASES = {
    "round_robin": (_payload(lb="round_robin"), {}),
    "lc_mixed": (_lc_mixed(), {}),
    "ram_overflow": (_payload(ram_mb=256, ram=128, io=0.25), {"pool_size": 2}),
    "truncation": (_payload(lb="round_robin"), {"max_iterations": 40}),
    "event_inj": (_event_inj(), {}),
    "controls_breaker_rr": (_controls_breaker("round_robin"), {}),
    "controls_breaker_lc": (_controls_breaker("least_connection"), {}),
    "controls_events": (_events_and_controls(), {}),
    **{name: (make(), {"pool_size": pool}) for name, (make, pool, _) in POOL_CASES.items()},
    **{
        name: (make(), {} if cap is None else {"max_iterations": cap})
        for name, (make, cap) in WORKLOAD_CASES.items()
    },
}


@pytest.mark.parametrize("name", list(CASES))
def test_host_build_of_the_kernel_matches_the_twin(host_kernel, name: str) -> None:
    data, kw = CASES[name]
    plan = compile_payload(SimulationPayload.from_dict(data), pool_size=kw.get("pool_size"))
    if "max_iterations" in kw:
        plan = dataclasses.replace(plan, max_iterations=kw["max_iterations"])
    args = KernelEngine(plan, device="cpu").prepare(scenario_keys(5, S))
    want = des_reference(*args)
    workload = des_kernel.needs_workload(args[0])
    assert workload == (name in WORKLOAD_CASES)
    packed, got, _keep = des_kernel.pack_args(*args, lib=host_kernel[workload])
    layout = des_kernel.query_layout(host_kernel[workload], packed)
    assert layout["placement"] == (POOL_CASES[name][2] if name in POOL_CASES else "scan_shared")
    assert layout["instance"]["workload"] == workload
    # each build refuses the other's plans
    assert host_kernel[not workload].des_launch(ctypes.byref(packed), None) != 0
    assert host_kernel[workload].des_launch(ctypes.byref(packed), None) == 0
    rows_equal = np.ones(S, bool)
    for field in ("hist", "thr", "momi", "trunc", "n_events", "work"):
        a = getattr(want, field).reshape(S, -1).numpy()
        b = getattr(got, field).reshape(S, -1).numpy()
        rows_equal &= (a == b).all(axis=1)
        assert abs(int(a.astype(np.int64).sum()) - int(b.astype(np.int64).sum())) <= 1, field
    assert rows_equal.sum() >= S - 1, rows_equal
    torch.testing.assert_close(got.momf, want.momf, rtol=1e-4, atol=1e-5)
    if name.startswith("controls"):
        assert int(want.momi[:, 4].sum()) > 0
    if name == "truncation":
        assert bool(want.trunc.all())


#: the only functions that dereference a word of state directly: each lane
#: reads or writes only its own slots there (init_state also the server,
#: LB-slot and generator words, before the warp's one barrier)
DIRECT_STATE_ACCESS = {"init_state", "pool_min", "head_waiter", "first_idle"}
STATE_DEREF = re.compile(r"\*(?:as_float\()?(?:pi|pf|si|li|gi)\(")
DEVICE_FUNCTION = re.compile(r"^\s*(?:static\s+)?__device__\s+__forceinline__\s+[^(]*?(\w+)\(")


def test_only_the_owner_lane_touches_a_word_of_state() -> None:
    """Every other read or write of a word of state goes through the owner
    helpers (pget, sget, ...), which load on the owner lane and shuffle: a
    lane that loaded a word another lane stores would race with it, and the
    one-lane host build cannot show that."""
    where = None
    found = []
    for number, line in enumerate(SOURCE.read_text().splitlines(), 1):
        head = DEVICE_FUNCTION.match(line)
        if head:
            where = head.group(1)
        if STATE_DEREF.search(line):
            found.append((where, number, line.strip()))
    assert {fn for fn, _, _ in found} == DIRECT_STATE_ACCESS
    stray = [f"{number}: {line}" for fn, number, line in found if fn not in DIRECT_STATE_ACCESS]
    assert not stray, stray
