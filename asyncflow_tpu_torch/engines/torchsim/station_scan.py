"""FIFO station recursions of the scan fast path over time-sorted streams,
with the CUDA kernel that walks them (``csrc/station_scan.cu``).

Each row of an (S, m) input is one station's merged stream of one
scenario, in its time order (lanes of other stations masked invalid
anywhere in it).  The plain versions compute what the kernel computes,
operation for operation, vectorised over the rows; all but Lindley's step
through the stream one element at a time:

- :func:`lindley_plain`, c = 1: the completion recursion
  ``C_k = max(A_k + S_k, C_{k-1} + S_k)`` as the reference's
  ``_lindley_waits`` (``fastpath.py:278``) evaluates it, a max-plus
  ``associative_scan`` in JAX's tree order (:func:`_maxplus_scan`: about
  2 log2(m) passes), and the wait ``max(0, (C_k - S_k) - A_k)``: equal to
  the jitted reference's bit for bit;
- :func:`kw_plain`, c > 1: the Kiefer-Wolfowitz vector of the c core-free
  times (``_kw_waits``, ``:198``);
- :func:`ram_core_plain`: the joint FIFO of RAM admission slots and cores
  (``_ram_core_scan``, ``:233``), returning (admission wait, core wait,
  departure);
- :func:`token_bucket_plain`: the arrival-order token bucket
  (``_token_bucket_scan``, ``:302``), returning the accepted flags: the
  client retry budget's pass over the retry wants, and a server's rate
  limit over its arrivals;
- :func:`controlled_plain`: the FIFO core queue under a ready-queue cap
  and a dequeue deadline (``_controlled_station_scan``, ``:331``): the
  Kiefer-Wolfowitz vector and a ring of the last ``max(cap, 1)`` grant
  times, returning the wait and a flag byte (bit 0 shed, bit 1 abandoned);
- :func:`socket_plain`: the same under a connection cap
  (``_socket_station_scan``, ``:374``), in arrival order, with the sorted
  vector of the connections' exit times besides (bit 2 of its flag byte:
  refused).

Invalid entries leave the carry as it is (their outputs are computed and
ignored), so a stream may interleave other stations' lanes.
Invalid Lindley entries are the scan's identity, but their positions shape
its tree, so the rows keep the reference's positions.
:class:`StationScan` is the wrapper: CUDA tensors launch the kernel (built
on first use) or raise, CPU tensors run the plain version.  The kernel
walks a row with a block in Lindley's mode, in the same tree (the tree
walk, :data:`WALK_TREE`); with one warp in the
bucket's mode (its chain over the valid elements only), the carry modes,
and the controlled and socket modes past the lane walk's shapes, each
carry vector spread over the warp's lanes, or whole on every lane where it
is narrow (:func:`carry_form`; the socket mode's connections always
spread); with one lane in the controlled and socket modes up to
:data:`LANE_WHOLE` ring entries, cores and (socket) connections, every
vector whole in the lane's registers.  A vector wider than
:data:`WARP_WIDTH_MAX` entries (a core count the schema does not bound)
goes back to one thread a row with the carry in global scratch
(:func:`walk_of`).
"""

from __future__ import annotations

import ctypes

import torch

from asyncflow_tpu_torch.engines.torchsim import _build
from asyncflow_tpu_torch.engines.torchsim.draws import fma_xla
from asyncflow_tpu_torch.engines.torchsim.params import INF
from asyncflow_tpu_torch.engines.torchsim.sampling import f32
from asyncflow_tpu_torch.errors import KernelBuildError, KernelLaunchError

MODE_LINDLEY = 0
MODE_KW = 1
MODE_RAM_CORE = 2
MODE_BUCKET = 3
MODE_CONTROLLED = 4
MODE_SOCKET = 5
#: each mode's name, as ``StationScan.mode_launches`` counts it
MODE_NAMES = {MODE_LINDLEY: "lindley", MODE_KW: "kw", MODE_RAM_CORE: "ram_core",
              MODE_BUCKET: "bucket", MODE_CONTROLLED: "controlled", MODE_SOCKET: "socket"}
#: the flag bits of the controlled and socket modes
FLAG_SHED = 1
FLAG_ABANDONED = 2
FLAG_REFUSED = 4
#: the widest ready-queue ring and connection vector the two modes take
#: (the compiler refuses larger caps on the fast path)
RING_MAX = 128
#: the kernel's walks (station_scan.cu, ``station_scan_walk``): a block a
#: row in the reference's tree order (Lindley), one warp a row (the bucket;
#: the carry modes up to WARP_WIDTH_MAX entries a vector, the carry over its
#: lanes), one thread a row with the carry in global scratch (wider), one
#: lane a row (the controlled and socket modes up to LANE_WHOLE entries a
#: vector)
WALK_TREE = 0
WALK_WARP = 1
WALK_GLOBAL = 2
WALK_LANE = 3
WALK_NAMES = {WALK_TREE: "tree", WALK_WARP: "warp", WALK_GLOBAL: "global",
              WALK_LANE: "lane"}
#: the widest ring, core vector and connection vector of the lane walk
#: (kLaneWhole)
LANE_WHOLE = 8
#: lanes of the warp walk, the widest carry vector it holds, and the widest
#: it holds whole on every lane (kLanes, kWarpWidthMax, kWholeMax)
WARP_LANES = 32
WARP_WIDTH_MAX = 1024
WHOLE_MAX = 4


def walk_of(mode: int, cores: int, ram_k: int, cap: int = -1) -> int:
    """The walk the kernel takes for a launch (``station_scan_walk``);
    ``ram_k`` is the RAM slots in the RAM-core mode and the connection cap
    in the socket mode, ``cap`` the ready-queue cap."""
    if mode == MODE_LINDLEY:
        return WALK_TREE
    if mode == MODE_BUCKET:
        return WALK_WARP
    if (mode == MODE_CONTROLLED or (mode == MODE_SOCKET and ram_k <= LANE_WHOLE)) \
            and max(cap, cores) <= LANE_WHOLE:
        return WALK_LANE
    width = max(cores, ram_k) if mode in (MODE_RAM_CORE, MODE_SOCKET) else cores
    return WALK_WARP if width <= WARP_WIDTH_MAX else WALK_GLOBAL


def carry_form(width: int, lanes: int = WARP_LANES) -> tuple[int, int]:
    """How the warp walk holds a vector of ``width`` floats: (entries a
    lane, lanes it spans) (``station_scan_lane_entries``,
    ``station_scan_lane_span``).  Up to :data:`WHOLE_MAX` entries (and
    always with one lane, the host build's) the whole vector on every lane,
    padded to a power of two; wider, spread over the lanes, each the
    smallest power of two E with ``lanes * E >= width``."""
    if width <= WHOLE_MAX or lanes == 1:
        return 1 << (width - 1).bit_length(), 1
    return 1 << (-(-width // lanes) - 1).bit_length(), lanes


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def lindley_plain(a: torch.Tensor, d: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(S, m) single-server FIFO waits of sorted arrivals ``a``, services
    ``d`` and validity ``v``: the completion clocks as the inclusive
    max-plus scan of ``e_k = (svc_k, arr_k + svc_k)`` (``-inf`` where
    invalid) in the reference's tree order (:func:`_maxplus_scan`)."""
    svc = torch.where(v, d, 0.0)
    arr = torch.where(v, a, 0.0)
    b = torch.where(v, arr + svc, -INF)
    _, cb = _maxplus_scan(svc, b)
    return torch.clamp_min((cb - svc) - arr, 0.0)


def _maxplus_scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The inclusive scan along each row of ``(a, b)`` under ``(a1, b1) o
    (a2, b2) = (a1 + a2, max(b2, b1 + a2))``, as ``jax.lax.associative_scan``
    evaluates it: pair elements (2j, 2j + 1), scan the pairs, then element
    2j is ``scan[j - 1] o e[2j]``.  So the prefix at k is the left fold,
    largest first, of the aligned power-of-two blocks of k + 1, each
    block's aggregate a balanced pairwise tree; the tree does not depend
    on the row's length."""
    m = a.shape[1]
    if m < 2:
        return a, b
    ra = a[:, 1::2]
    odd_a, odd_b = _maxplus_scan(a[:, 0:-1:2] + ra, torch.maximum(b[:, 1::2], b[:, 0:-1:2] + ra))
    if m % 2 == 0:
        left_a, left_b = odd_a[:, :-1], odd_b[:, :-1]
    else:
        left_a, left_b = odd_a, odd_b
    ea = a[:, 2::2]
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 0], out_b[:, 0] = a[:, 0], b[:, 0]
    out_a[:, 2::2] = left_a + ea
    out_b[:, 2::2] = torch.maximum(b[:, 2::2], left_b + ea)
    out_a[:, 1::2], out_b[:, 1::2] = odd_a, odd_b
    return out_a, out_b


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


def token_bucket_plain(t: torch.Tensor, v: torch.Tensor, rate: float,
                       burst: float) -> torch.Tensor:
    """(S, m) bool accepted flags of the token bucket over sorted times
    ``t`` and validity ``v``: full (``burst`` tokens) at time 0, refilled
    ``rate`` a second up to ``burst``, accepting a valid element holding a
    whole token and spending it; its tokens and clock advance on every
    valid element, refused ones included (``_token_bucket_scan``).  Float32
    throughout, each operation rounded on its own but the refill's multiply
    and add, which the jitted reference rounds once (a fused multiply-add)."""
    rate32 = torch.tensor(rate, dtype=torch.float32, device=t.device)
    burst32 = torch.tensor(burst, dtype=torch.float32, device=t.device)
    tokens = burst32.expand(t.shape[0]).clone()
    last = torch.zeros_like(tokens)
    out = torch.empty_like(v)
    for k in range(t.shape[1]):
        tk, vk = t[:, k], v[:, k]
        tok = torch.minimum(burst32, fma_xla(tk - last, rate32, tokens))
        acc = vk & (tok >= 1.0)
        tok = tok - torch.where(acc, 1.0, 0.0)
        tokens = torch.where(vk, tok, tokens)
        last = torch.where(vk, tk, last)
        out[:, k] = acc
    return out


class _Ring:
    """Each row's ring of the last ``max(cap, 1)`` grant times, -INF at
    first, as a circular buffer: ``oldest`` is the entry the reference's
    shifting ring holds first."""

    def __init__(self, rows: int, cap: int, device) -> None:
        self.r = max(cap, 1)
        self.f = torch.full((rows, self.r), -INF, dtype=torch.float32, device=device)
        self.head = torch.zeros((rows, 1), dtype=torch.int64, device=device)

    def oldest(self) -> torch.Tensor:
        return self.f.gather(1, self.head)[:, 0]

    def push(self, g: torch.Tensor, on: torch.Tensor) -> None:
        self.f = torch.where(on[:, None], self.f.scatter(1, self.head, g[:, None]), self.f)
        self.head = torch.where(on[:, None], (self.head + 1) % self.r, self.head)


def controlled_plain(e: torch.Tensor, d: torch.Tensor, v: torch.Tensor, cores: int, cap: int,
                     timeout: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(wait, flags), (S, m) float32 and uint8, of a ``cores``-server FIFO
    over the enqueue times ``e`` (sorted), services ``d`` and validity
    ``v`` under a ready-queue cap (``cap`` >= 0; the ring is kept, never
    tested, below 0) and a dequeue deadline (``timeout`` >= 0): an element
    is shed where the oldest of the last ``max(cap, 1)`` grants lies after
    its enqueue, abandoned where it is live and waits past the deadline
    (it frees its core at its grant); a live element takes a core and its
    grant enters the ring (``_controlled_station_scan``)."""
    s_rows, m = e.shape
    cap_on, to_on, limit = cap >= 0, timeout >= 0.0, f32(timeout)
    w = torch.zeros((s_rows, cores), dtype=e.dtype, device=e.device)
    ring = _Ring(s_rows, cap, e.device)
    wait = torch.empty_like(e)
    flags = torch.empty((s_rows, m), dtype=torch.uint8, device=e.device)
    for k in range(m):
        ek, dk, ok = e[:, k], d[:, k], v[:, k]
        shed = ok & (ring.oldest() > ek) if cap_on else torch.zeros_like(ok)
        g = torch.maximum(ek, w[:, 0])
        wk = g - ek
        live = ok & ~shed
        ab = live & (wk > limit) if to_on else torch.zeros_like(ok)
        w0 = g + torch.where(ab, 0.0, dk)
        w = torch.where(live[:, None], insert_sorted(w, w0), w)
        ring.push(g, live)
        wait[:, k] = wk
        flags[:, k] = shed.to(torch.uint8) * FLAG_SHED + ab.to(torch.uint8) * FLAG_ABANDONED
    return wait, flags


def socket_plain(a: torch.Tensor, e: torch.Tensor, d: torch.Tensor, post: torch.Tensor,
                 b: torch.Tensor, v: torch.Tensor, cores: int, conn: int, cap: int,
                 timeout: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(wait, flags) of a server under a connection cap of ``conn``, in
    arrival order: arrivals ``a`` (sorted), enqueue times ``e``, services
    ``d``, trailing IO ``post``, burst flags ``b`` (io-only elements take
    no core) and validity ``v``; the ready-queue cap and deadline as in
    :func:`controlled_plain`.  An arrival is refused where every
    connection's exit lies after it; an admitted one holds a connection
    until its exit (its enqueue if shed, its grant if abandoned, else the
    end of its service and trailing IO; ``a + post`` on an io-only
    element) (``_socket_station_scan``)."""
    s_rows, m = a.shape
    cap_on, to_on, limit = cap >= 0, timeout >= 0.0, f32(timeout)
    w = torch.zeros((s_rows, cores), dtype=a.dtype, device=a.device)
    exits = torch.full((s_rows, conn), -INF, dtype=a.dtype, device=a.device)
    ring = _Ring(s_rows, cap, a.device)
    wait = torch.empty_like(a)
    flags = torch.empty((s_rows, m), dtype=torch.uint8, device=a.device)
    for k in range(m):
        ak, ek, dk, pk, bk, ok = a[:, k], e[:, k], d[:, k], post[:, k], b[:, k], v[:, k]
        refused = ok & (exits[:, 0] > ak)
        live = ok & ~refused
        shed = live & bk & (ring.oldest() > ek) if cap_on else torch.zeros_like(ok)
        g = torch.maximum(ek, w[:, 0])
        wk = torch.where(bk, g - ek, 0.0)
        through = live & bk & ~shed
        ab = through & (wk > limit) if to_on else torch.zeros_like(ok)
        exit_t = torch.where(bk, torch.where(shed, ek, torch.where(ab, g, (g + dk) + pk)),
                             ak + pk)
        exits = torch.where(live[:, None], insert_sorted(exits, exit_t), exits)
        w0 = g + torch.where(ab, 0.0, dk)
        w = torch.where(through[:, None], insert_sorted(w, w0), w)
        ring.push(g, through)
        wait[:, k] = wk
        flags[:, k] = (shed.to(torch.uint8) * FLAG_SHED + ab.to(torch.uint8) * FLAG_ABANDONED
                       + refused.to(torch.uint8) * FLAG_REFUSED)
    return wait, flags


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


class _StationArgs(ctypes.Structure):
    """Mirror of ``struct StationArgs`` in station_scan.cu (same order)."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "a", "d", "v", "pre", "post", "out0", "out1", "out2", "scratch", "flag", "e", "b",
        )]
        + [(name, ctypes.c_int64) for name in ("S", "m")]
        + [(name, ctypes.c_int32) for name in ("mode", "cores", "ram_k", "cap", "conn")]
        + [(name, ctypes.c_float) for name in ("rate", "burst", "timeout")]
    )


def _library() -> ctypes.CDLL:
    lib = _build.load("station_scan")
    lib.station_scan_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.station_scan_launch.restype = ctypes.c_int
    lib.station_scan_args_size.argtypes = []
    lib.station_scan_args_size.restype = ctypes.c_int
    lib.station_scan_walk.argtypes = [ctypes.c_int] * 4
    lib.station_scan_walk.restype = ctypes.c_int
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

    def bucket(self, t, v, rate: float, burst: float):
        return token_bucket_plain(t, v, rate, burst)

    def controlled(self, e, d, v, cores: int, cap: int, timeout: float):
        return controlled_plain(e, d, v, cores, cap, timeout)

    def socket(self, a, e, d, post, b, v, cores: int, conn: int, cap: int, timeout: float):
        return socket_plain(a, e, d, post, b, v, cores, conn, cap, timeout)


class StationScan:
    """The station recursions with their launch count, in all, by mode
    (``mode_launches``: Lindley, Kiefer-Wolfowitz, RAM-core, the token
    bucket, the controlled and the socket scans) and by walk
    (``walk_launches``: the tree walk, a block a row; a warp a row; the
    global-scratch walk, a thread a row; a lane a row).  A carry vector of up to :data:`WARP_WIDTH_MAX`
    entries is held by a warp's lanes (:func:`carry_form`); a wider one
    lives in global scratch that the launch allocates.  The lane walk takes
    its inputs on 16-byte boundaries: an input off one is copied first."""

    name = "station_scan"
    route = "cuda"
    source = "asyncflow_tpu_torch/csrc/station_scan.cu"
    replaces = (
        "asyncflow_tpu/engines/jaxsim/fastpath.py:278 (_lindley_waits), :198 (_kw_waits), "
        ":233 (_ram_core_scan), :302 (_token_bucket_scan), :331 (_controlled_station_scan), "
        ":374 (_socket_station_scan)"
    )

    def __init__(self) -> None:
        self.launches = 0
        self.mode_launches = dict.fromkeys(MODE_NAMES.values(), 0)
        self.walk_launches = dict.fromkeys(WALK_NAMES.values(), 0)

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

    def bucket(self, t: torch.Tensor, v: torch.Tensor, rate: float, burst: float):
        """(S, m) bool accepted flags of the token bucket over each row's
        sorted times ``t`` and validity ``v`` (:func:`token_bucket_plain`)."""
        if t.device.type == "cpu":
            return PlainStationScan().bucket(t, v, rate, burst)
        flag = torch.empty_like(v)
        self._launch(MODE_BUCKET, 1, 0, rate=float(rate), burst=float(burst), a=t, v=v,
                     flag=flag)
        return flag

    def controlled(self, e: torch.Tensor, d: torch.Tensor, v: torch.Tensor, cores: int,
                   cap: int, timeout: float) -> tuple[torch.Tensor, torch.Tensor]:
        """(wait, flags) of the FIFO core queue under a ready-queue cap and
        a dequeue deadline over each row's sorted enqueue times
        (:func:`controlled_plain`)."""
        if e.device.type == "cpu":
            return PlainStationScan().controlled(e, d, v, cores, cap, timeout)
        _check_cap(cap)
        wait = torch.empty_like(e)
        flags = torch.empty(e.shape, dtype=torch.uint8, device=e.device)
        self._launch(MODE_CONTROLLED, cores, 0, cap=cap, timeout=f32(timeout), a=e, d=d, v=v,
                     out0=wait, flag=flags)
        return wait, flags

    def socket(self, a, e, d, post, b, v, cores: int, conn: int, cap: int,
               timeout: float) -> tuple[torch.Tensor, torch.Tensor]:
        """(wait, flags) of a server under a connection cap over each row's
        sorted arrivals (:func:`socket_plain`)."""
        if a.device.type == "cpu":
            return PlainStationScan().socket(a, e, d, post, b, v, cores, conn, cap, timeout)
        _check_cap(cap)
        if not 1 <= conn <= RING_MAX:
            msg = f"station_scan: the connection cap {conn} must lie in 1..{RING_MAX}"
            raise ValueError(msg)
        wait = torch.empty_like(a)
        flags = torch.empty(a.shape, dtype=torch.uint8, device=a.device)
        self._launch(MODE_SOCKET, cores, conn, cap=cap, timeout=f32(timeout), a=a, e=e, d=d,
                     post=post, b=b, v=v, out0=wait, flag=flags)
        return wait, flags

    def _launch(self, mode: int, cores: int, ram_k: int, *, rate: float = 0.0,
                burst: float = 0.0, cap: int = -1, timeout: float = -1.0, **tensors) -> None:
        a = tensors["a"]
        dev = a.device
        if dev.type != "cuda":
            msg = f"station_scan runs on cuda or cpu tensors, got {dev}"
            raise ValueError(msg)
        if cores < 1 or (mode == MODE_RAM_CORE and ram_k < 1):
            msg = f"station_scan: cores {cores} and RAM slots {ram_k} must be positive"
            raise ValueError(msg)
        s, m = a.shape
        flag_dtype = torch.uint8 if mode in (MODE_CONTROLLED, MODE_SOCKET) else torch.bool
        for name, t in tensors.items():
            dtype = (flag_dtype if name == "flag" else torch.bool if name in ("v", "b")
                     else torch.float32)
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
        walk = lib.station_scan_walk(mode, cores, ram_k, cap)
        if walk == WALK_LANE:
            for name, t in tensors.items():
                if not name.startswith("out") and name != "flag" and t.data_ptr() % 16:
                    tensors[name] = t.clone()
        if walk == WALK_GLOBAL:
            width = cores + (ram_k if mode in (MODE_RAM_CORE, MODE_SOCKET) else 0)
            tensors["scratch"] = torch.empty((s, width), dtype=torch.float32, device=dev)
        conn = ram_k if mode == MODE_SOCKET else 0
        args = _StationArgs(S=s, m=m, mode=mode, cores=cores,
                            ram_k=ram_k if mode == MODE_RAM_CORE else 0, rate=rate,
                            burst=burst, cap=cap, conn=conn, timeout=timeout)
        for name, t in tensors.items():
            setattr(args, name, t.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.station_scan_launch(ctypes.byref(args), ctypes.c_void_p(stream))
        if rc != 0:
            msg = f"station_scan launch failed: code {rc}"
            raise KernelLaunchError(msg)
        self.launches += 1
        self.mode_launches[MODE_NAMES[mode]] += 1
        self.walk_launches[WALK_NAMES[walk]] += 1


def _check_cap(cap: int) -> None:
    if cap > RING_MAX:
        msg = f"station_scan: the ready-queue cap {cap} exceeds the ring's {RING_MAX} entries"
        raise ValueError(msg)
