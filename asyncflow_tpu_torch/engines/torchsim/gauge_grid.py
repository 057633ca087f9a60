"""The fast path's gauge grid: the gauge sites' intervals scattered onto the
sample ticks (the reference's ``FastEngine._gauge_intervals``).

An interval ``[t0, t1)`` of a lane with ``on`` adds ``+amount`` at the
bucket of ``t0`` and ``-amount`` at the bucket of ``t1``
(``sampling.sample_bucket``) into its gauge's column of the (S, rows,
n_gauges) float32 grid; the cumulative sum over the rows then gives each
tick's gauge value.  Sites that share their operands go as one group:

- a site alone (:func:`gauge_add_plain`): the entry and exit hops, a
  connection cap's refused RAM;
- a server's ready queue and pre-IO sleep at one visit
  (:func:`gauge_queue_plain`), from the enqueue times, waits, pre-IO
  sleeps and the visit's validity;
- a server's trailing IO sleep and RAM (:func:`gauge_trail_plain`), from
  the trailing IO's start, the departures, the arrivals, the RAM waits,
  the server's lanes and their RAM;
- the LB's edges (:func:`gauge_slots_plain`), each lane into the column of
  its slot: its arrival rank modulo the slots, or its slot.

The plain versions build each group's intervals with the torch expressions
the engine's sites used and scatter them with ``scatter_add_``.  On a CUDA
tensor :class:`GaugeGrid` launches ``csrc/gauge_grid.cu``, one launch a
group, which forms the intervals itself from the same operands; on a CPU
tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from asyncflow_tpu_torch.engines.torchsim import _build
from asyncflow_tpu_torch.engines.torchsim.sampling import bucket_scale, sample_bucket
from asyncflow_tpu_torch.errors import KernelBuildError, KernelLaunchError

#: the kernel's group forms (``kSite`` .. ``kSlots`` in gauge_grid.cu)
FORM_SITE, FORM_QUEUE, FORM_TRAIL, FORM_SLOTS = range(4)
#: the LB slots a launch takes (the columns of its argument struct)
MAX_COLS = 32


def gauge_add_plain(grid: torch.Tensor, col: int, t0: torch.Tensor, t1: torch.Tensor,
                    on: torch.Tensor, amount, period: float) -> None:
    """Add one site's intervals into column ``col`` of ``grid`` (S, rows, G)
    in place: ``t0``, ``t1`` (S, n) float32, ``on`` (S, n) bool, ``amount``
    a float or (S, n) float32."""
    n_samples = grid.shape[1] - 2
    val = torch.where(on, amount, 0.0).to(torch.float32)
    column = grid[:, :, col]
    column.scatter_add_(1, sample_bucket(t0, period, n_samples), val)
    column.scatter_add_(1, sample_bucket(t1, period, n_samples), -val)


def gauge_queue_plain(grid, cols: tuple, e, w, p, vb, period: float) -> None:
    """A visit's ready queue [e, e + w) where ``vb & (w > 0)`` into
    ``cols[0]``, and its pre-IO sleep [e - p, e) where ``vb & (p > 0)`` into
    ``cols[1]``, +1 each."""
    gauge_add_plain(grid, cols[0], e, e + w, vb & (w > 0), 1.0, period)
    gauge_add_plain(grid, cols[1], e - p, e, vb & (p > 0), 1.0, period)


def gauge_trail_plain(grid, cols: tuple, start, dep, t, w_ram, mine, ram, period: float) -> None:
    """A server's trailing IO sleep [start, dep) where ``mine & (dep >
    start)`` into ``cols[0]``, +1, and its RAM [t + w_ram, dep) where
    ``mine & (ram > 0)`` into ``cols[1]``, +ram (``w_ram`` None: none)."""
    gauge_add_plain(grid, cols[0], start, dep, mine & (dep > start), 1.0, period)
    held = t if w_ram is None else t + w_ram
    gauge_add_plain(grid, cols[1], held, dep, mine & (ram > 0), ram, period)


def gauge_slots_plain(grid, cols: tuple, t0, t1, ok, period: float, *, rank=None,
                      slot=None) -> None:
    """The LB's edges: each lane's interval [t0, t1) where ``ok`` into
    ``cols[k]`` of its slot k, ``rank % len(cols)`` or ``slot``, +1."""
    pick = rank % len(cols) if rank is not None else slot
    for k, col in enumerate(cols):
        gauge_add_plain(grid, col, t0, t1, ok & (pick == k), 1.0, period)


class PlainGaugeGrid:
    """The plain versions with the wrapper's interface, on any device."""

    launches = 0

    def add(self, grid, col, t0, t1, on, amount, period) -> None:
        gauge_add_plain(grid, col, t0, t1, on, amount, period)

    def add_queue(self, grid, cols, e, w, p, vb, period) -> None:
        gauge_queue_plain(grid, cols, e, w, p, vb, period)

    def add_trail(self, grid, cols, start, dep, t, w_ram, mine, ram, period) -> None:
        gauge_trail_plain(grid, cols, start, dep, t, w_ram, mine, ram, period)

    def add_slots(self, grid, cols, t0, t1, ok, period, *, rank=None, slot=None) -> None:
        gauge_slots_plain(grid, cols, t0, t1, ok, period, rank=rank, slot=slot)


class _GaugeGridArgs(ctypes.Structure):
    """Mirror of ``struct GaugeGridArgs`` in gauge_grid.cu (same order)."""

    _fields_ = (
        [("f", ctypes.c_void_p * 5)]
        + [(name, ctypes.c_void_p) for name in ("on", "idx", "grid")]
        + [(name, ctypes.c_int64) for name in ("S", "n")]
        + [(name, ctypes.c_int32) for name in ("rows", "G", "form", "ncols")]
        + [("cols", ctypes.c_int32 * MAX_COLS)]
        + [(name, ctypes.c_int32) for name in ("idx_bytes", "idx_mod")]
        + [(name, ctypes.c_float) for name in ("scale", "amount_scalar")]
    )


def _library() -> ctypes.CDLL:
    lib = _build.load("gauge_grid")
    lib.gauge_grid_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.gauge_grid_launch.restype = ctypes.c_int
    lib.gauge_grid_args_size.restype = ctypes.c_int
    lib.gauge_grid_shared_rows.restype = ctypes.c_int
    lib.gauge_grid_shared_cells.restype = ctypes.c_int
    if lib.gauge_grid_args_size() != ctypes.sizeof(_GaugeGridArgs):
        msg = "GaugeGridArgs layout mismatch between gauge_grid.cu and its ctypes mirror"
        raise KernelBuildError(msg)
    return lib


class GaugeGrid:
    """The gauge grid's scatter, a launch a group of sites, with the launch
    count (``launches``), each form's (``form_launches``: the columns in
    shared memory, or global atomics for grids past the shared form's rows
    and cells) and each group's (``group_launches``)."""

    name = "gauge_grid"
    route = "cuda"
    source = "asyncflow_tpu_torch/csrc/gauge_grid.cu"
    replaces = ("asyncflow_tpu/engines/jaxsim/fastpath.py:1138-1144 (_gauge_intervals: "
                "XLA's scatter-add of each interval's endpoints; no Pallas kernel)")

    def __init__(self) -> None:
        self.launches = 0
        self.form_launches = {"shared": 0, "global": 0}
        self.group_launches = {"site": 0, "queue": 0, "trail": 0, "slots": 0}

    def add(self, grid: torch.Tensor, col: int, t0: torch.Tensor, t1: torch.Tensor,
            on: torch.Tensor, amount, period: float) -> None:
        """Add one gauge site's intervals into column ``col`` of ``grid``
        (S, rows, G) float32, in place (:func:`gauge_add_plain`)."""
        if grid.device.type == "cpu":
            gauge_add_plain(grid, col, t0, t1, on, amount, period)
            return
        lane_amount = isinstance(amount, torch.Tensor) and amount.ndim > 0
        self._launch(grid, FORM_SITE, (col,), period, on,
                     (t0, t1, amount if lane_amount else None),
                     amount_scalar=0.0 if lane_amount else float(amount))

    def add_queue(self, grid, cols: tuple, e, w, p, vb, period: float) -> None:
        """A visit's ready queue and pre-IO sleep (:func:`gauge_queue_plain`)
        in one launch."""
        if grid.device.type == "cpu":
            gauge_queue_plain(grid, cols, e, w, p, vb, period)
            return
        self._launch(grid, FORM_QUEUE, cols, period, vb, (e, w, p))

    def add_trail(self, grid, cols: tuple, start, dep, t, w_ram, mine, ram,
                  period: float) -> None:
        """A server's trailing IO sleep and RAM (:func:`gauge_trail_plain`)
        in one launch."""
        if grid.device.type == "cpu":
            gauge_trail_plain(grid, cols, start, dep, t, w_ram, mine, ram, period)
            return
        self._launch(grid, FORM_TRAIL, cols, period, mine, (start, dep, t, w_ram, ram))

    def add_slots(self, grid, cols: tuple, t0, t1, ok, period: float, *, rank=None,
                  slot=None) -> None:
        """The LB's edges (:func:`gauge_slots_plain`) in one launch, each
        lane's column chosen in the kernel."""
        if (rank is None) == (slot is None):
            msg = "gauge_grid.add_slots takes exactly one of rank and slot"
            raise ValueError(msg)
        if grid.device.type == "cpu":
            gauge_slots_plain(grid, cols, t0, t1, ok, period, rank=rank, slot=slot)
            return
        idx = rank if rank is not None else slot
        if idx.dtype not in (torch.int32, torch.int64):
            msg = f"gauge_grid: the lanes' rank or slot must be int32 or int64, got {idx.dtype}"
            raise ValueError(msg)
        self._launch(grid, FORM_SLOTS, cols, period, ok, (t0, t1), idx=idx,
                     idx_mod=rank is not None)

    def _launch(self, grid, form: int, cols, period: float, on, floats: tuple, *,
                amount_scalar: float = 0.0, idx=None, idx_mod: bool = False) -> None:
        dev = grid.device
        if dev.type != "cuda":
            msg = f"gauge_grid runs on cuda or cpu tensors, got {dev}"
            raise ValueError(msg)
        if grid.dtype != torch.float32 or not grid.is_contiguous():
            msg = "gauge_grid: the grid must be a contiguous float32 tensor"
            raise ValueError(msg)
        s, rows, g = grid.shape
        cols = [int(c) for c in cols]
        if not 0 < len(cols) <= MAX_COLS or len(set(cols)) != len(cols) or not all(
                0 <= c < g for c in cols):
            msg = f"gauge_grid: {len(cols)} distinct columns of the grid's {g} needed, got {cols}"
            raise ValueError(msg)
        n = on.shape[1]
        shape = (s, n)
        on = _lanes(on, torch.bool, shape, dev, "on")
        floats = [None if x is None else _lanes(x, torch.float32, shape, dev, f"operand {i}")
                  for i, x in enumerate(floats)]
        if idx is not None:
            idx = _lanes(idx, idx.dtype, shape, dev, "rank or slot")
        if s == 0 or n == 0:
            return
        lib = _library()
        args = _GaugeGridArgs(
            on=on.data_ptr(), idx=None if idx is None else idx.data_ptr(),
            grid=grid.data_ptr(), S=s, n=n, rows=rows, G=g, form=form, ncols=len(cols),
            idx_bytes=0 if idx is None else idx.element_size(), idx_mod=int(idx_mod),
            scale=bucket_scale(period), amount_scalar=amount_scalar,
        )
        for i, x in enumerate(floats):
            args.f[i] = None if x is None else x.data_ptr()
        for i, c in enumerate(cols):
            args.cols[i] = c
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gauge_grid_launch(ctypes.byref(args), ctypes.c_void_p(stream))
        if rc != 0:
            msg = f"gauge_grid launch failed: code {rc}"
            raise KernelLaunchError(msg)
        self.launches += 1
        shared = (rows <= lib.gauge_grid_shared_rows()
                  and rows * len(cols) <= lib.gauge_grid_shared_cells())
        self.form_launches["shared" if shared else "global"] += 1
        self.group_launches[("site", "queue", "trail", "slots")[form]] += 1


def _lanes(x: torch.Tensor, dtype: torch.dtype, shape: tuple, dev, name: str) -> torch.Tensor:
    """``x`` as a contiguous (S, n) tensor of ``dtype`` on ``dev`` (a copy
    where it is a strided view or of another type)."""
    if tuple(x.shape) != shape or x.device != dev:
        msg = (f"gauge_grid: {name} must have shape {shape} on {dev}, got "
               f"{tuple(x.shape)} on {x.device}")
        raise ValueError(msg)
    return x.to(dtype).contiguous()
