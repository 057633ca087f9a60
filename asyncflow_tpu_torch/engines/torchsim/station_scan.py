"""FIFO station recursions of the scan fast path over time-sorted streams,
with the CUDA kernel that walks them (``csrc/station_scan.cu``).

Each row of an (S, m) input is one station's merged stream of one
scenario, in its time order (lanes of other stations masked invalid
anywhere in it).  The plain versions step through the stream one element
at a time, vectorised over the rows, and compute what the kernel
computes, operation for operation:

- :func:`lindley_plain`, c = 1: the completion recursion
  ``C_k = max(A_k + S_k, C_{k-1} + S_k)`` and the wait
  ``max(0, (C_k - S_k) - A_k)`` (the reference's ``_lindley_waits``,
  ``fastpath.py:278``, evaluates the same recursion as a max-plus
  ``associative_scan``, whose float sums associate differently);
- :func:`kw_plain`, c > 1: the Kiefer-Wolfowitz vector of the c core-free
  times (``_kw_waits``, ``:198``);
- :func:`ram_core_plain`: the joint FIFO of RAM admission slots and cores
  (``_ram_core_scan``, ``:233``), returning (admission wait, core wait,
  departure).

Invalid entries leave the carry as it is (their outputs are computed and
ignored), so a stream may interleave other stations' lanes.
:class:`StationScan` is the wrapper: CUDA tensors launch the kernel (built
on first use) or raise, CPU tensors run the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from asyncflow_tpu_torch.engines.torchsim import _build
from asyncflow_tpu_torch.engines.torchsim.params import INF
from asyncflow_tpu_torch.errors import KernelBuildError, KernelLaunchError

MODE_LINDLEY = 0
MODE_KW = 1
MODE_RAM_CORE = 2
#: core-free and RAM-slot vectors of up to these many floats live in
#: registers; a wider carry in global scratch (station_scan.cu, kRegCores,
#: kRegSlots; the library's station_scan_scratch_floats decides)
REG_CORES = 8
REG_SLOTS = 32


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def lindley_plain(a: torch.Tensor, d: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(S, m) single-server FIFO waits of sorted arrivals ``a``, services
    ``d`` and validity ``v``."""
    svc = torch.where(v, d, 0.0)
    arr = torch.where(v, a, 0.0)
    b = torch.where(v, arr + svc, -INF)
    c = torch.full_like(a[:, 0], -INF)
    out = torch.empty_like(a)
    for k in range(a.shape[1]):
        c = torch.maximum(b[:, k], c + svc[:, k])
        out[:, k] = torch.clamp_min((c - svc[:, k]) - arr[:, k], 0.0)
    return out


def insert_sorted(f: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Each row of ascending ``f`` with its first entry replaced by
    ``value`` (never below it), sorted again."""
    return torch.sort(torch.cat([value[:, None], f[:, 1:]], dim=1), dim=1).values


def kw_plain(a: torch.Tensor, d: torch.Tensor, v: torch.Tensor, cores: int) -> torch.Tensor:
    """(S, m) FIFO waits of a ``cores``-server station (Kiefer-Wolfowitz)."""
    arr = torch.where(v, a, 0.0)
    svc = torch.where(v, d, 0.0)
    f = torch.zeros((a.shape[0], cores), dtype=a.dtype, device=a.device)
    out = torch.empty_like(a)
    for k in range(a.shape[1]):
        ok = v[:, k]
        f0 = f[:, 0]
        out[:, k] = torch.where(ok, torch.clamp_min(f0 - arr[:, k], 0.0), 0.0)
        busy = insert_sorted(f, torch.maximum(f0, arr[:, k]) + svc[:, k])
        f = torch.where(ok[:, None], busy, f)
    return out


def ram_core_plain(
    a: torch.Tensor,
    pre: torch.Tensor,
    svc: torch.Tensor,
    post: torch.Tensor,
    v: torch.Tensor,
    ram_k: int,
    cores: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(admission wait, core wait, departure), (S, m) each, of a server with
    ``ram_k`` FIFO admission slots and ``cores`` cores: grant
    ``g = max(a, slot_free)``, burst start ``s = max(g + pre, core_free)``
    (where the burst is not empty), release ``s + svc + post``."""
    s_rows = a.shape[0]
    wr = torch.zeros((s_rows, ram_k), dtype=a.dtype, device=a.device)
    wc = torch.zeros((s_rows, cores), dtype=a.dtype, device=a.device)
    w_ram, w_cpu, dep = (torch.empty_like(a) for _ in range(3))
    for k in range(a.shape[1]):
        ak, pk, dk, ok = a[:, k], pre[:, k], svc[:, k], v[:, k]
        g = torch.maximum(ak, wr[:, 0])
        enq = g + pk
        start = torch.where(dk > 0, torch.maximum(enq, wc[:, 0]), enq)
        rel = (start + dk) + post[:, k]
        wc = torch.where((ok & (dk > 0))[:, None], insert_sorted(wc, start + dk), wc)
        wr = torch.where(ok[:, None], insert_sorted(wr, rel), wr)
        w_ram[:, k] = g - ak
        w_cpu[:, k] = start - enq
        dep[:, k] = rel
    return w_ram, w_cpu, dep


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


class _StationArgs(ctypes.Structure):
    """Mirror of ``struct StationArgs`` in station_scan.cu (same order)."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "a", "d", "v", "pre", "post", "out0", "out1", "out2", "scratch",
        )]
        + [(name, ctypes.c_int64) for name in ("S", "m")]
        + [(name, ctypes.c_int32) for name in ("mode", "cores", "ram_k")]
    )


def _library() -> ctypes.CDLL:
    lib = _build.load("station_scan")
    lib.station_scan_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.station_scan_launch.restype = ctypes.c_int
    lib.station_scan_args_size.argtypes = []
    lib.station_scan_args_size.restype = ctypes.c_int
    lib.station_scan_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.station_scan_scratch_floats.restype = ctypes.c_int
    if lib.station_scan_args_size() != ctypes.sizeof(_StationArgs):
        msg = "StationArgs layout mismatch between station_scan.cu and its ctypes mirror"
        raise KernelBuildError(msg)
    return lib


class PlainStationScan:
    """The plain versions behind :class:`StationScan`'s interface, on any
    device: what a check on the card holds the kernel to.  The engine's
    own path never takes it."""

    def waits(self, a, d, v, cores: int):
        return lindley_plain(a, d, v) if cores == 1 else kw_plain(a, d, v, cores)

    def ram_core(self, a, pre, svc, post, v, ram_k: int, cores: int):
        return ram_core_plain(a, pre, svc, post, v, ram_k, cores)


class StationScan:
    """The station recursions with their launch count.  A carry of up to
    :data:`REG_CORES` cores and :data:`REG_SLOTS` RAM slots lives in
    registers, a wider one in global scratch that the launch allocates."""

    name = "station_scan"
    route = "cuda"
    source = "asyncflow_tpu_torch/csrc/station_scan.cu"
    replaces = (
        "asyncflow_tpu/engines/jaxsim/fastpath.py:278 (_lindley_waits), :198 (_kw_waits), "
        ":233 (_ram_core_scan)"
    )

    def __init__(self) -> None:
        self.launches = 0

    def waits(self, a: torch.Tensor, d: torch.Tensor, v: torch.Tensor, cores: int):
        """(S, m) FIFO waits of a ``cores``-server station."""
        if a.device.type == "cpu":
            return PlainStationScan().waits(a, d, v, cores)
        out = torch.empty_like(a)
        mode = MODE_LINDLEY if cores == 1 else MODE_KW
        self._launch(mode, cores, 0, a=a, d=d, v=v, out0=out)
        return out

    def ram_core(self, a, pre, svc, post, v, ram_k: int, cores: int):
        """(admission wait, core wait, departure) of the joint RAM and core
        FIFO, (S, m) each."""
        if a.device.type == "cpu":
            return PlainStationScan().ram_core(a, pre, svc, post, v, ram_k, cores)
        outs = [torch.empty_like(a) for _ in range(3)]
        self._launch(MODE_RAM_CORE, cores, ram_k, a=a, d=svc, v=v, pre=pre, post=post,
                     out0=outs[0], out1=outs[1], out2=outs[2])
        return tuple(outs)

    def _launch(self, mode: int, cores: int, ram_k: int, **tensors) -> None:
        a = tensors["a"]
        dev = a.device
        if dev.type != "cuda":
            msg = f"station_scan runs on cuda or cpu tensors, got {dev}"
            raise ValueError(msg)
        if cores < 1 or (mode == MODE_RAM_CORE and ram_k < 1):
            msg = f"station_scan: cores {cores} and RAM slots {ram_k} must be positive"
            raise ValueError(msg)
        s, m = a.shape
        for name, t in tensors.items():
            dtype = torch.bool if name == "v" else torch.float32
            if t.dtype != dtype or tuple(t.shape) != (s, m) or not t.is_contiguous() \
                    or t.device != dev:
                msg = (
                    f"station_scan: {name} must be a contiguous {dtype} tensor of shape "
                    f"{(s, m)} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                )
                raise ValueError(msg)
        if s == 0 or m == 0:
            return
        lib = _library()
        width = lib.station_scan_scratch_floats(mode, cores, ram_k)
        if width > 0:
            tensors["scratch"] = torch.empty((s, width), dtype=torch.float32, device=dev)
        args = _StationArgs(S=s, m=m, mode=mode, cores=cores, ram_k=ram_k)
        for name, t in tensors.items():
            setattr(args, name, t.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.station_scan_launch(ctypes.byref(args), ctypes.c_void_p(stream))
        if rc != 0:
            msg = f"station_scan launch failed: code {rc}"
            raise KernelLaunchError(msg)
        self.launches += 1
