"""Round robin under an outage timeline and least connections: the port of
the reference fast path's ``_routed_slots``, ``_routed_slots_lc`` and
``_advance_timeline`` (``asyncflow_tpu/engines/jaxsim/fastpath.py:1037-1065``,
``:1067-1127``, ``:1008-1035``), with the CUDA kernels that compute them
(``csrc/lb_route.cu``).

The reference scans a scenario's arrivals in time order carrying the LB
rotation (a dense prefix of slot ids with a length): before each arrival
it applies every down / up mark whose time is at most the arrival's
(remove the slot, or append it at the tail), then the arrival takes the
head, and the head moves to the tail.  An empty rotation picks -1 (no
healthy target: the request is dropped at the LB) and does not turn.

Between two marks the rotation only turns, so the scan has a segment
form: segment 0 holds the arrivals before the first mark, segment j + 1
those after mark j, starting at the running maximum over i <= j of the
count of alive arrivals with ``t < tl_time[i]`` (a mark at exactly an
arrival's time applies first).  Walking the marks once gives each
segment's start rank and starting rotation, and each lane's pick is then
``rot[(rank - start) % length]``.

- :func:`rotation_remove`, :func:`rotation_insert`,
  :func:`rotation_advance`: the port's copies of the reference's
  ``engines/jaxsim/rotation.py``, batched over scenarios;
- :func:`routed_slots_scan`: the reference's scan replayed one arrival at
  a time (the tests' oracle, at small sizes);
- :func:`route_table_plain`, :func:`route_slots_plain`: the segment form,
  as the kernel computes it;
- :func:`lc_picks_plain`: least connections over time-sorted arrivals (the
  reference's scan, which the kernel walks too: a pick depends on every
  earlier delivery, so it has no segment form), and
  :func:`routed_slots_lc_plain`, the same on lanes in any order;
- :class:`LbRoute`: the wrapper.  On CUDA tensors it launches the kernels
  (built on first use) or raises; on CPU tensors it runs the plain
  versions.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from asyncflow_tpu_torch.engines.torchsim import _build
from asyncflow_tpu_torch.engines.torchsim.params import INF
from asyncflow_tpu_torch.engines.torchsim.sortutil import time_rank, to_sorted
from asyncflow_tpu_torch.errors import KernelBuildError, KernelLaunchError

MODE_TABLE = 0
MODE_LANES = 1
MODE_LC = 2
#: the kernel's limits on marks and LB slots (its shared memory)
MAX_MARKS = 4096
MAX_SLOTS = 1024
#: least connections: the LB slots and the in-flight ring of each slot the
#: kernel takes (the compiler's bound on the ring is 128)
MAX_LC_SLOTS = 32
MAX_LC_RING = 128


# ---------------------------------------------------------------------------
# the rotation, batched over scenarios: rot (S, EL) int, length (S,) int
# ---------------------------------------------------------------------------


def rotation_remove(rot, length, slot, pred, el: int):
    """Remove ``slot`` from each row's prefix (no-op where absent or where
    ``pred`` is false)."""
    pos = torch.arange(el, device=rot.device)[None, :]
    hit = torch.where((rot == slot[:, None]) & (pos < length[:, None]), pos, el)
    at = hit.min(dim=1).values
    act = pred & (at < el)
    shifted = rot[:, torch.clamp_max(torch.arange(el, device=rot.device) + 1, el - 1)]
    return (
        torch.where((pos >= at[:, None]) & act[:, None], shifted, rot),
        torch.where(act, length - 1, length),
    )


def rotation_insert(rot, length, slot, pred, el: int):
    """Append ``slot`` at each row's tail (no-op where present or where
    ``pred`` is false)."""
    pos = torch.arange(el, device=rot.device)[None, :]
    present = ((rot == slot[:, None]) & (pos < length[:, None])).any(dim=1)
    act = pred & ~present
    at = torch.clamp(length, 0, el - 1)
    put = act[:, None] & (pos == at[:, None])
    return (
        torch.where(put, slot[:, None].to(rot.dtype), rot),
        torch.where(act, torch.clamp_max(length + 1, el), length),
    )


def rotation_advance(rot, length, pred, el: int):
    """Move each row's head to its tail (a round-robin pick) where ``pred``."""
    pos = torch.arange(el, device=rot.device)[None, :]
    src = (pos + 1) % torch.clamp_min(length, 1)[:, None]
    rotated = torch.where(pos < length[:, None], rot.gather(1, src), rot)
    return torch.where(pred[:, None], rotated, rot)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def routed_slots_scan(t, alive, tl_time, tl_down, tl_slot, el: int):
    """(slot, routed), (S, n) each: the reference's ``_routed_slots``, one
    arrival at a time in each row's time order, applying the marks with
    ``_advance_timeline``'s loop before each arrival."""
    s_rows, n = t.shape
    dev = t.device
    rank = time_rank(t, alive)
    t_sorted = torch.full_like(t, INF).scatter_(1, rank, torch.where(alive, t, INF))
    ok_sorted = torch.zeros_like(alive).scatter_(1, rank, alive)
    rot = torch.arange(el, dtype=torch.int64, device=dev).expand(s_rows, el).clone()
    length = torch.full((s_rows,), el, dtype=torch.int64, device=dev)
    ptr = torch.zeros(s_rows, dtype=torch.int64, device=dev)
    picked = torch.empty((s_rows, n), dtype=torch.int64, device=dev)
    times, downs, slots = tl_time.to(dev), tl_down.to(dev).long(), tl_slot.to(dev).long()
    for i in range(n):
        t_arr, ok = t_sorted[:, i], ok_sorted[:, i]
        rot, length, ptr = _advance_marks(rot, length, ptr, t_arr, times, downs, slots, el)
        take = ok & (length > 0)
        picked[:, i] = torch.where(take, rot[:, 0], -1)
        rot = rotation_advance(rot, length, take, el)
    slot = picked.gather(1, rank).to(torch.int32)
    return slot, slot >= 0


def _advance_marks(rot, length, ptr, t_arr, times, downs, slots, el: int):
    """``_advance_timeline``: apply, in table order, every mark whose time
    is at most each row's ``t_arr``."""
    ntl = int(times.shape[0])
    while ntl:
        idx = torch.clamp_max(ptr, ntl - 1)
        cond = (ptr < ntl) & (times[idx] <= t_arr)
        if not bool(cond.any()):
            break
        s, down = slots[idx], downs[idx] == 1
        act = cond & (s >= 0)
        rot, length = rotation_remove(rot, length, s, act & down, el)
        rot, length = rotation_insert(rot, length, s, act & ~down, el)
        ptr = ptr + cond.long()
    return rot, length, ptr


def lc_picks_plain(t, ok, deliv, drop, tl_time, tl_down, tl_slot, el: int, ring: int):
    """(S, n) int32 least-connections pick of each arrival, in each row's
    time order: arrivals ``t`` (sorted, INF past the alive ones) and ``ok``,
    and each arrival's candidate delivery time and drop on every LB slot,
    ``deliv`` and ``drop`` (S, n, EL).  Each slot carries a ring of
    ``ring`` outstanding delivery times (-INF at first); before an arrival
    the marks whose time has come are applied to the rotation; the arrival
    takes the rotation's first position ``pos`` with the fewest ring
    entries after it (the first minimum of ``count * el + pos``), -1 where
    the rotation is empty, and unless its send on that slot is dropped its
    delivery time replaces the smallest entry of that slot's ring (the
    ring matters only through its counts, so which tied smallest entry is
    replaced changes no result) (``_routed_slots_lc``)."""
    s_rows, n = t.shape
    dev = t.device
    times, downs, slots = tl_time.to(dev), tl_down.to(dev).long(), tl_slot.to(dev).long()
    rot = torch.arange(el, dtype=torch.int64, device=dev).expand(s_rows, el).clone()
    length = torch.full((s_rows,), el, dtype=torch.int64, device=dev)
    ptr = torch.zeros(s_rows, dtype=torch.int64, device=dev)
    rings = torch.full((s_rows, el, max(ring, 1)), -INF, dtype=torch.float32, device=dev)
    pos = torch.arange(el, device=dev)[None, :]
    rows = torch.arange(s_rows, device=dev)
    picked = torch.empty((s_rows, n), dtype=torch.int32, device=dev)
    for i in range(n):
        t_arr = t[:, i]
        rot, length, ptr = _advance_marks(rot, length, ptr, t_arr, times, downs, slots, el)
        conn = (rings > t_arr[:, None, None]).sum(dim=2)
        key = torch.where(pos < length[:, None], conn.gather(1, rot) * el + pos, 2**30)
        best = key.argmin(dim=1)
        slot = rot.gather(1, best[:, None])[:, 0]
        take = ok[:, i] & (length > 0)
        picked[:, i] = torch.where(take, slot, -1).to(torch.int32)
        row = torch.clamp(slot, 0, el - 1)
        put = take & ~drop[rows, i, row]
        j = rings[rows, row].argmin(dim=1)
        rings[rows, row, j] = torch.where(put, deliv[rows, i, row], rings[rows, row, j])
    return picked


def route_table_plain(t, alive, tl_time, tl_down, tl_slot, el: int) -> torch.Tensor:
    """(S, NTL + 1, 2 + EL) int32: each segment's start rank, its rotation's
    length and the rotation (-1 past the length), as the table kernel
    writes it."""
    s_rows = t.shape[0]
    dev = t.device
    ntl = int(tl_time.shape[0])
    times = tl_time.to(dev)
    counts = torch.stack([(alive & (t < times[j])).sum(dim=1) for j in range(ntl)], dim=1) \
        if ntl else torch.zeros((s_rows, 0), dtype=torch.int64, device=dev)
    starts = torch.cummax(counts, dim=1).values if ntl else counts
    pos = torch.arange(el, device=dev)[None, :]
    rot = torch.arange(el, dtype=torch.int64, device=dev).expand(s_rows, el).clone()
    length = torch.full((s_rows,), el, dtype=torch.int64, device=dev)
    start = torch.zeros(s_rows, dtype=torch.int64, device=dev)
    table = torch.empty((s_rows, ntl + 1, 2 + el), dtype=torch.int32, device=dev)
    downs, slots = tl_down.to(dev).long(), tl_slot.to(dev).long()
    for j in range(ntl + 1):
        table[:, j, 0] = start
        table[:, j, 1] = length
        table[:, j, 2:] = torch.where(pos < length[:, None], rot, -1)
        if j == ntl:
            break
        nxt = starts[:, j]
        # the segment's picks turn the rotation, one place each
        span = torch.clamp_min(length, 1)[:, None]
        turn = torch.where(length > 0, (nxt - start) % torch.clamp_min(length, 1), 0)
        src = (pos + turn[:, None]) % span
        rot = torch.where(pos < length[:, None], rot.gather(1, src), rot)
        start = nxt
        s = slots[j].expand(s_rows)
        if int(slots[j]) >= 0:
            down = bool(downs[j] == 1)
            on = torch.ones(s_rows, dtype=torch.bool, device=dev)
            if down:
                rot, length = rotation_remove(rot, length, s, on, el)
            else:
                rot, length = rotation_insert(rot, length, s, on, el)
    return table


def route_slots_plain(table: torch.Tensor, rank: torch.Tensor, alive: torch.Tensor):
    """(S, n) int32 LB slot of each lane from its row's table: the last
    segment whose start is at most the lane's rank, ``rot[(rank - start) %
    length]``, and -1 where the length is 0 or the lane is dead."""
    starts = table[:, :, 0].long().contiguous()
    seg = torch.searchsorted(starts, rank.contiguous(), right=True) - 1
    seg = torch.clamp_min(seg, 0)
    length = table[:, :, 1].long().gather(1, seg)
    off = (rank - starts.gather(1, seg)) % torch.clamp_min(length, 1)
    width = table.shape[2]
    flat = table.reshape(table.shape[0], -1).long()
    slot = flat.gather(1, seg * width + 2 + off)
    return torch.where(alive & (length > 0), slot, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


class _LbRouteArgs(ctypes.Structure):
    """Mirror of ``struct LbRouteArgs`` in lb_route.cu (same order)."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "t", "alive", "rank", "tl_time", "tl_down", "tl_slot", "partial", "table",
            "slot", "deliv", "drop",
        )]
        + [(name, ctypes.c_int64) for name in ("S", "n")]
        + [(name, ctypes.c_int32) for name in ("NTL", "EL", "mode", "R")]
    )


def _library() -> ctypes.CDLL:
    lib = _build.load("lb_route")
    lib.lb_route_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.lb_route_launch.restype = ctypes.c_int
    lib.lb_route_args_size.argtypes = []
    lib.lb_route_args_size.restype = ctypes.c_int
    lib.lb_route_row_blocks.argtypes = [ctypes.c_int64]
    lib.lb_route_row_blocks.restype = ctypes.c_int64
    if lib.lb_route_args_size() != ctypes.sizeof(_LbRouteArgs):
        msg = "LbRouteArgs layout mismatch between lb_route.cu and its ctypes mirror"
        raise KernelBuildError(msg)
    return lib


class Timeline:
    """An outage timeline on one device: (NTL,) mark times (float32), down
    flags and LB slots (int32), in table order, over ``el`` LB slots."""

    def __init__(self, times, down, slot, el: int, device) -> None:
        self.times = torch.as_tensor(times, dtype=torch.float32, device=device).contiguous()
        self.down = torch.as_tensor(down, dtype=torch.int32, device=device).contiguous()
        self.slot = torch.as_tensor(slot, dtype=torch.int32, device=device).contiguous()
        self.el = int(el)
        ntl = self.times.shape[0]
        if self.down.shape != (ntl,) or self.slot.shape != (ntl,):
            msg = "timeline: times, down and slot must have one entry a mark"
            raise ValueError(msg)
        if ntl and (int(self.slot.min()) < -1 or int(self.slot.max()) >= self.el):
            msg = f"timeline: every slot must be -1 or one of the {self.el} LB slots"
            raise ValueError(msg)

    @property
    def n_marks(self) -> int:
        return int(self.times.shape[0])


class PlainLbRoute:
    """The plain versions behind :class:`LbRoute`'s interface, on any
    device: what a check on the card holds the kernels to."""

    def table(self, tl: Timeline, t, alive):
        return route_table_plain(t, alive, tl.times, tl.down, tl.slot, tl.el)

    def slots(self, table, rank, alive):
        return route_slots_plain(table, rank, alive)

    def lc(self, tl: Timeline, t, ok, deliv, drop, ring: int):
        return lc_picks_plain(t, ok, deliv, drop, tl.times, tl.down, tl.slot, tl.el, ring)


class LbRoute:
    """Round robin under an outage timeline and least connections, with
    the launch count (``launches``) and least connections' own
    (``lc_launches``)."""

    name = "lb_route"
    route = "cuda"
    source = "asyncflow_tpu_torch/csrc/lb_route.cu"
    replaces = (
        "asyncflow_tpu/engines/jaxsim/fastpath.py:1037 (_routed_slots: a lax.scan over the "
        "arrivals), :1008 (_advance_timeline: its lax.while_loop over the marks), :1067 "
        "(_routed_slots_lc: a lax.scan over the arrivals with each slot's in-flight ring)"
    )

    def __init__(self) -> None:
        self.launches = 0
        self.lc_launches = 0

    def table(self, tl: Timeline, t: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
        """(S, NTL + 1, 2 + EL) int32 segment table of the lanes ``t`` (S, n)
        float32 and ``alive`` (S, n) bool (:func:`route_table_plain`)."""
        if t.device.type == "cpu":
            return PlainLbRoute().table(tl, t, alive)
        s, n = t.shape
        _need(t, torch.float32, (s, n), t.device, "t")
        _need(alive, torch.bool, (s, n), t.device, "alive")
        for name in ("times", "down", "slot"):
            if getattr(tl, name).device != t.device:
                msg = f"lb_route: the timeline's {name} must lie on {t.device}"
                raise ValueError(msg)
        table = torch.empty((s, tl.n_marks + 1, 2 + tl.el), dtype=torch.int32,
                            device=t.device)
        # each count block's counts of the marks, summed by the marks' walk
        blocks = _library().lb_route_row_blocks(n) if s and n else 0
        partial = torch.empty((s, blocks, tl.n_marks), dtype=torch.int32, device=t.device)
        self._launch(MODE_TABLE, s, n, tl.n_marks, tl.el, t=t, alive=alive, table=table,
                     partial=partial, tl_time=tl.times, tl_down=tl.down, tl_slot=tl.slot)
        return table

    def slots(self, table: torch.Tensor, rank: torch.Tensor, alive: torch.Tensor):
        """(S, n) int32 LB slot of each lane, -1 where none is healthy or the
        lane is dead (:func:`route_slots_plain`); ``rank`` (S, n) int64 is
        the lanes' arrival rank (``sortutil.time_rank``)."""
        if rank.device.type == "cpu":
            return PlainLbRoute().slots(table, rank, alive)
        s, n = rank.shape
        ntl, el = table.shape[1] - 1, table.shape[2] - 2
        _need(table, torch.int32, (s, ntl + 1, el + 2), rank.device, "table")
        _need(rank, torch.int64, (s, n), rank.device, "rank")
        _need(alive, torch.bool, (s, n), rank.device, "alive")
        out = torch.empty((s, n), dtype=torch.int32, device=rank.device)
        self._launch(MODE_LANES, s, n, ntl, el, rank=rank, alive=alive, table=table, slot=out)
        return out

    def lc(self, tl: Timeline, t: torch.Tensor, ok: torch.Tensor, deliv: torch.Tensor,
           drop: torch.Tensor, ring: int) -> torch.Tensor:
        """(S, n) int32 least-connections pick of each arrival in each row's
        time order (:func:`lc_picks_plain`): ``t`` (S, n) float32 and ``ok``
        (S, n) bool sorted by time, ``deliv`` (S, n, EL) float32 and
        ``drop`` (S, n, EL) bool in the same order; ``ring`` in-flight
        entries a slot.  The kernel relies on the order: an entry at or
        before one arrival never counts for a later one."""
        if t.device.type == "cpu":
            return PlainLbRoute().lc(tl, t, ok, deliv, drop, ring)
        s, n = t.shape
        el = tl.el
        _need(t, torch.float32, (s, n), t.device, "t")
        _need(ok, torch.bool, (s, n), t.device, "ok")
        _need(deliv, torch.float32, (s, n, el), t.device, "deliv")
        _need(drop, torch.bool, (s, n, el), t.device, "drop")
        for name in ("times", "down", "slot"):
            if getattr(tl, name).device != t.device:
                msg = f"lb_route: the timeline's {name} must lie on {t.device}"
                raise ValueError(msg)
        if not 1 <= el <= MAX_LC_SLOTS or not 1 <= ring <= MAX_LC_RING:
            msg = (f"lb_route: least connections takes 1..{MAX_LC_SLOTS} LB slots and rings "
                   f"of 1..{MAX_LC_RING} entries, got {el} and {ring}")
            raise ValueError(msg)
        out = torch.empty((s, n), dtype=torch.int32, device=t.device)
        self._launch(MODE_LC, s, n, tl.n_marks, el, ring=ring, t=t, alive=ok, deliv=deliv,
                     drop=drop, tl_time=tl.times, tl_down=tl.down, tl_slot=tl.slot, slot=out)
        return out

    def _launch(self, mode: int, s: int, n: int, ntl: int, el: int, ring: int = 0,
                **tensors) -> None:
        dev = tensors["alive"].device
        if dev.type != "cuda":
            msg = f"lb_route runs on cuda or cpu tensors, got {dev}"
            raise ValueError(msg)
        if ntl > MAX_MARKS or not 1 <= el <= MAX_SLOTS:
            msg = f"lb_route takes at most {MAX_MARKS} marks and 1..{MAX_SLOTS} LB slots"
            raise ValueError(msg)
        if s == 0 or n == 0:
            return
        lib = _library()
        args = _LbRouteArgs(S=s, n=n, NTL=ntl, EL=el, mode=mode, R=ring)
        for name, t in tensors.items():
            if t is not None and t.numel():
                setattr(args, name, t.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lb_route_launch(ctypes.byref(args), ctypes.c_void_p(stream))
        if rc != 0:
            msg = f"lb_route launch failed: code {rc}"
            raise KernelLaunchError(msg)
        self.launches += 1
        if mode == MODE_LC:
            self.lc_launches += 1


def _need(x: torch.Tensor, dtype: torch.dtype, shape: tuple, dev, name: str) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() or x.device != dev:
        msg = (
            f"lb_route: {name} must be a contiguous {dtype} tensor of shape {shape} on "
            f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}"
        )
        raise ValueError(msg)


def route_lanes(engine_route, tl: Timeline, t: torch.Tensor, alive: torch.Tensor):
    """(S, n) int32 LB slot of each alive lane sending at ``t`` (the
    arrival rank, the table, the lanes), -1 where none is healthy."""
    rank = time_rank(t, alive)
    return engine_route.slots(engine_route.table(tl, t, alive), rank, alive)


def route_lanes_lc(engine_route, tl: Timeline, t, alive, deliv, drop, ring: int):
    """(S, n) int32 least-connections LB slot of each alive lane sending at
    ``t``, -1 where none is healthy: the lanes and their (S, n, EL)
    candidate deliveries and drops put in time order (dead lanes last),
    the picks, and the picks put back in lane order."""
    rank = time_rank(t, alive)
    by_slot = rank[..., None].expand_as(deliv)
    picks = engine_route.lc(
        tl, to_sorted(torch.where(alive, t, INF), rank, INF), to_sorted(alive, rank, False),
        torch.full_like(deliv, -INF).scatter_(1, by_slot, deliv),
        torch.zeros_like(drop).scatter_(1, by_slot, drop), ring,
    )
    return picks.gather(1, rank)


def routed_slots_lc_plain(t, alive, drop, deliv, tl_time, tl_down, tl_slot, el: int,
                          ring: int):
    """(slot, routed), (S, n) each: ``_routed_slots_lc`` on lanes in any
    order, through :func:`lc_picks_plain`."""
    tl = Timeline(tl_time, tl_down, tl_slot, el, t.device)
    slot = route_lanes_lc(PlainLbRoute(), tl, t, alive, deliv, drop, ring)
    return slot, slot >= 0
