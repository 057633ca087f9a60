"""The fast path's blame grid: every latency credit of a chunk's lanes
summed into the (S, n_cells, nbb) float32 grid keyed by each lane's coarse
latency bin, and the latencies into the (S, nbb) totals (the reference's
blame scatter in ``FastEngine._run_one``).

A credit is a lane's seconds in one (component, phase) cell
(``observability/blame.py``), (S, n) float32 with its predicate folded in
as 0.0: its cell is one for every lane (:attr:`Credit.cell`) or each lane's
own, the cell of its slot (:attr:`Credit.slot`, :attr:`Credit.slot_cells`:
the LB hop's edges).  A lane's target is its coarse bin where its request
succeeded, else ``nbb`` (dropped).

The plain version sums each credit in float64 with ``scatter_add_``, credit
by credit, and rounds once.  On a CUDA tensor :class:`BlameGrid` launches
``csrc/blame_grid.cu`` (a block a slice of a row, each segment of its lanes
sorted once by (bin, slot), a credit's runs summed by stretches of sorted
lanes), whose float64 sums run in a fixed order, so two launches give the
same bits; a cell may differ from the plain version's by one float32 ulp
(the order of the float64 sums).  On a CPU tensor it runs the plain
version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from asyncflow_tpu_torch.engines.torchsim import _build
from asyncflow_tpu_torch.errors import KernelBuildError, KernelLaunchError

#: blocks a launch aims at (several waves of the card's 132 SMs, so that the
#: last, part-empty wave costs little): a row's lanes are cut into slices
#: until the grid has about these many
TARGET_BLOCKS = 4096
#: the most coarse bins the kernel takes (its counting sort's keys, less the
#: dropped lanes' key: kMaxKeys - 1)
MAX_BINS = 511


class Credit(NamedTuple):
    """One credit of every lane: ``secs`` (S, n) float32, zero where the
    credit does not apply; ``cell`` its cell, or None with ``slot`` (S, n)
    each lane's index into ``slot_cells``."""

    secs: torch.Tensor
    cell: int | None = None
    slot: torch.Tensor | None = None
    slot_cells: tuple[int, ...] = ()

    def cells(self) -> torch.Tensor | int:
        """The credit's cell: an int, or (S, n) int64 of each lane's."""
        if self.cell is not None:
            return self.cell
        table = torch.as_tensor(self.slot_cells, dtype=torch.int64, device=self.secs.device)
        return table[self.slot.long()]


def blame_grid_plain(credits: list[Credit], target: torch.Tensor, latency: torch.Tensor,
                     n_cells: int, nbb: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(grid (S, n_cells, nbb), totals (S, nbb)) float32: each credit's
    seconds and the latencies added in float64 at (cell, target), credit by
    credit, then rounded; a target outside [0, nbb) drops."""
    s, n = target.shape
    dev = target.device
    tgt = target.long()
    drop = (tgt < 0) | (tgt >= nbb)
    tgt = torch.where(drop, nbb, tgt)
    grid = torch.zeros((s, n_cells * (nbb + 1)), dtype=torch.float64, device=dev)
    for c in credits:
        key = torch.as_tensor(c.cells(), device=dev) * (nbb + 1) + tgt
        grid.scatter_add_(1, key.expand(s, n), c.secs.double())
    lat = torch.zeros((s, nbb + 1), dtype=torch.float64, device=dev)
    lat.scatter_add_(1, tgt, latency.double())
    return (grid.view(s, n_cells, nbb + 1)[..., :nbb].float().contiguous(),
            lat[:, :nbb].float().contiguous())


class _BlameGridArgs(ctypes.Structure):
    """Mirror of ``struct BlameGridArgs`` in blame_grid.cu (same order)."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in ("secs", "slots", "cand_row", "slot_row",
                                              "row_cell", "target", "partial", "grid",
                                              "lat_out")]
        + [(name, ctypes.c_int64) for name in ("S", "n")]
        + [(name, ctypes.c_int32) for name in ("C", "n_cells", "nbb", "rows", "u_lo", "u_hi",
                                               "n_slices", "slice_len")]
    )


def _library() -> ctypes.CDLL:
    lib = _build.load("blame_grid")
    lib.blame_grid_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.blame_grid_launch.restype = ctypes.c_int
    lib.blame_grid_args_size.restype = ctypes.c_int
    lib.blame_grid_pass_rows.argtypes = [ctypes.c_int]
    lib.blame_grid_pass_rows.restype = ctypes.c_int
    lib.blame_grid_segment_lanes.restype = ctypes.c_int
    if lib.blame_grid_args_size() != ctypes.sizeof(_BlameGridArgs):
        msg = "BlameGridArgs layout mismatch between blame_grid.cu and its ctypes mirror"
        raise KernelBuildError(msg)
    return lib


def blame_layout(credits: list[Credit]) -> tuple[list[int], list[int], list[int]]:
    """The rows the credits reach: (row_cell, cand_row, slot_row).  Each
    distinct cell gets a row in order of first use, then the latency row
    (cell -1); a static credit's ``cand_row`` is its row, a per-lane one's
    where its slots' rows start in ``slot_row``."""
    rows: dict[int, int] = {}
    cand_row, slot_row = [], []
    for c in credits:
        if c.cell is not None:
            cand_row.append(rows.setdefault(int(c.cell), len(rows)))
        else:
            cand_row.append(len(slot_row))
            slot_row.extend(rows.setdefault(int(x), len(rows)) for x in c.slot_cells)
    return [*rows, -1], cand_row, slot_row


class BlameGrid:
    """The blame grid's sums, a call a chunk, with the launch count
    (``launches``: one a call that launches, whatever its passes)."""

    name = "blame_grid"
    route = "cuda"
    source = "asyncflow_tpu_torch/csrc/blame_grid.cu"
    replaces = ("asyncflow_tpu/engines/jaxsim/fastpath.py:2259-2267 (the blame grid: "
                "XLA's scatter-add of every credit; no Pallas kernel)")

    def __init__(self) -> None:
        self.launches = 0

    def reduce(self, credits: list[Credit], target: torch.Tensor, latency: torch.Tensor,
               n_cells: int, nbb: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(grid (S, n_cells, nbb), totals (S, nbb)) float32 of the credits
        keyed by ``target`` (S, n; int16 is passed as it is, any other type
        converted): :func:`blame_grid_plain`'s sums."""
        dev = target.device
        if dev.type == "cpu":
            return blame_grid_plain(credits, target, latency, n_cells, nbb)
        if dev.type != "cuda":
            msg = f"blame_grid runs on cuda or cpu tensors, got {dev}"
            raise ValueError(msg)
        s, n = target.shape
        grid = torch.zeros((s, n_cells, nbb), dtype=torch.float32, device=dev)
        lat_out = torch.zeros((s, nbb), dtype=torch.float32, device=dev)
        if s == 0 or n == 0:
            return grid, lat_out
        shape = (s, n)
        secs, slots = [], []
        for i, c in enumerate(credits):
            secs.append(_lanes(c.secs, torch.float32, shape, dev, f"credit {i}"))
            if c.cell is None:
                if not 0 < len(c.slot_cells) <= 256:
                    msg = f"blame_grid: credit {i} needs 1 to 256 slot cells"
                    raise ValueError(msg)
                slots.append(_distinct_slots(
                    _lanes(c.slot, torch.uint8, shape, dev, f"credit {i}'s slots"),
                    c.slot_cells))
            else:
                slots.append(None)
        secs.append(_lanes(latency, torch.float32, shape, dev, "latency"))
        slots.append(None)
        row_cell, cand_row, slot_row = blame_layout(credits)
        cand_row.append(len(row_cell) - 1)
        if max((x for x in row_cell if x >= 0), default=0) >= n_cells:
            msg = f"blame_grid: a credit's cell is past the grid's {n_cells} cells"
            raise ValueError(msg)
        # the kernel drops a target outside [0, nbb) itself
        tgt = (target if target.dtype == torch.int16 and target.is_contiguous()
               else _lanes(torch.where((target < 0) | (target >= nbb), nbb, target),
                           torch.int16, shape, dev, "target"))
        if tuple(tgt.shape) != shape or tgt.device != dev:
            msg = f"blame_grid: the targets must have shape {shape} on {dev}"
            raise ValueError(msg)
        if nbb > MAX_BINS:
            msg = f"blame_grid: {nbb} coarse bins exceed the kernel's {MAX_BINS}"
            raise ValueError(msg)
        lib = _library()
        rows = len(row_cell)
        per_pass = lib.blame_grid_pass_rows(nbb)
        if per_pass < 1:
            msg = f"blame_grid: {nbb} coarse bins do not fit a pass"
            raise ValueError(msg)
        seg = lib.blame_grid_segment_lanes()
        n_slices = max(1, min(-(-TARGET_BLOCKS // s), -(-n // seg)))
        slice_len = -(-(-(-n // n_slices)) // seg) * seg
        n_slices = -(-n // slice_len)
        ptrs = torch.tensor([x.data_ptr() for x in secs], dtype=torch.int64, device=dev)
        slot_ptrs = torch.tensor([0 if x is None else x.data_ptr() for x in slots],
                                 dtype=torch.int64, device=dev)

        def i32(values) -> torch.Tensor:
            return torch.tensor(list(values) or [0], dtype=torch.int32, device=dev)

        cand_t, slot_t, cell_t = i32(cand_row), i32(slot_row), i32(row_cell)
        partial = torch.empty((s, n_slices, min(per_pass, rows), nbb), dtype=torch.float64,
                              device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for u_lo in range(0, rows, per_pass):
            args = _BlameGridArgs(
                secs=ptrs.data_ptr(), slots=slot_ptrs.data_ptr(), cand_row=cand_t.data_ptr(),
                slot_row=slot_t.data_ptr(), row_cell=cell_t.data_ptr(), target=tgt.data_ptr(),
                partial=partial.data_ptr(), grid=grid.data_ptr(), lat_out=lat_out.data_ptr(),
                S=s, n=n, C=len(secs), n_cells=n_cells, nbb=nbb, rows=rows, u_lo=u_lo,
                u_hi=min(rows, u_lo + per_pass), n_slices=n_slices, slice_len=slice_len,
            )
            rc = lib.blame_grid_launch(ctypes.byref(args), ctypes.c_void_p(stream))
            if rc != 0:
                msg = f"blame_grid launch failed: code {rc}"
                raise KernelLaunchError(msg)
        # the argument tensors may be freed now: the caching allocator hands
        # their memory only to work queued after these launches on the stream
        self.launches += 1
        return grid, lat_out


def _distinct_slots(slot: torch.Tensor, cells: tuple[int, ...]) -> torch.Tensor:
    """``slot`` with each slot whose cell an earlier slot has made that
    slot, so that the kernel's (bin, slot) runs of one credit add into
    cells of their own."""
    first = [cells.index(c) for c in cells]
    if first == list(range(len(cells))):
        return slot
    table = torch.tensor(first + [0] * (256 - len(first)), dtype=torch.uint8, device=slot.device)
    return table[slot.long()]


def _lanes(x: torch.Tensor, dtype: torch.dtype, shape: tuple, dev, name: str) -> torch.Tensor:
    """``x`` as a contiguous (S, n) tensor of ``dtype`` on ``dev``."""
    if tuple(x.shape) != shape or x.device != dev:
        msg = (f"blame_grid: {name} must have shape {shape} on {dev}, got "
               f"{tuple(x.shape)} on {x.device}")
        raise ValueError(msg)
    return x.to(dtype).contiguous()
