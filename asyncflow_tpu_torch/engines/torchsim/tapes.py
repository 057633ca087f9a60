"""The fast path's observability tapes (the reference's ``_FlightTape``,
``_flight_rings`` and ``_BlameTape``).

The fast path has no event loop, but along one lane the journey produces
its lifecycle transitions in event-processing order, and it computes every
wait and every realised time advance.  So:

- the flight recorder keeps, at each of the journey's emission sites in
  the reference's order, a candidate ``(code, node, record time, processing
  time, predicate)``; the rings are each traced lane's true candidates in
  that order (:func:`flight_rings`).  Only the traced lanes are kept: each
  emission gathers them (:class:`FlightTape`), so a candidate costs (S, K)
  and not (S, n);
- the blame plane keeps each credit of every lane, (S, n) float32 seconds
  with its predicate folded in as 0.0 and its cell
  (:class:`BlameTape`); the ``blame_grid`` kernel sums them keyed by each
  lane's coarse latency bin at the end of the run.

Both consume no draw: every candidate reuses what the journey computed.
"""

from __future__ import annotations

import torch

from asyncflow_tpu_torch.engines.torchsim.blame_grid import Credit
from asyncflow_tpu_torch.observability import blame as bl


class FlightTape:
    """Flight-record candidates of the traced lanes, in emission order.

    ``lanes`` (S, R) int64 holds the lane of each traced row; ``proc``
    keeps each candidate's processing time (the retry driver's orphan mask
    needs it)."""

    def __init__(self, lanes: torch.Tensor, *, proc: bool = False) -> None:
        self.lanes = lanes
        self.proc = proc
        #: (code, node, record time, processing time or None, predicate),
        #: (S, R) each
        self.cands: list[tuple] = []

    def _take(self, x, dtype: torch.dtype, idx: torch.Tensor) -> torch.Tensor:
        if isinstance(x, tuple):  # (table, each lane's index into it)
            table, at = x
            return table[at.gather(1, idx).clamp_min(0).long()].to(dtype)
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return torch.full(idx.shape, x.item() if isinstance(x, torch.Tensor) else x,
                              dtype=dtype, device=idx.device)
        return x.gather(1, idx).to(dtype)

    def emit(self, code: int, node, rec_t, proc_t, pred, *, off: int = 0) -> None:
        """A candidate of the lanes ``off .. off + width`` (the width of
        ``pred`` (S, width)): the traced lanes outside them get a false
        predicate (a stream's entry chain).  ``node`` is an int, a lane's
        (S, width), or (table, index) for ``table[index]`` of each lane."""
        width = pred.shape[1]
        local = self.lanes - off
        inside = (local >= 0) & (local < width)
        idx = local.clamp(0, width - 1)
        self.cands.append((
            int(code),
            self._take(node, torch.int32, idx),
            self._take(rec_t, torch.float32, idx),
            self._take(proc_t, torch.float32, idx) if self.proc else None,
            pred.gather(1, idx) & inside,
        ))


def flight_rings(cands: list[tuple], K: int, slots: int, *, blocks: tuple | None = None):
    """Candidates (S, R) each to ``(fr_ev, fr_node, fr_t, fr_n)``: (S, K,
    slots) int32, int32, float32 and (S, K) int32.  A traced row's ring
    holds its true candidates in order; writes past ``slots`` are counted in
    ``fr_n`` and not stored.  ``blocks = (A, k2)``: the rows are A attempt
    blocks of k2 logical requests (row ``a * k2 + r``), and request r's
    ring is the attempt-major concatenation of its blocks' candidates.
    Rows past R are zeros (fewer lanes than K)."""
    ev = torch.stack([torch.full_like(c[1], c[0]) for c in cands])  # (C, S, R)
    node = torch.stack([c[1] for c in cands])
    rec = torch.stack([c[2] for c in cands])
    pred = torch.stack([c[4] for c in cands])
    c_n, s, r = pred.shape
    if blocks is not None:
        a, k2 = blocks

        def fold(x: torch.Tensor) -> torch.Tensor:
            return x.view(c_n, s, a, k2).permute(2, 0, 1, 3).reshape(a * c_n, s, k2)

        ev, node, rec, pred = (fold(x) for x in (ev, node, rec, pred))
        r = k2
    cnt = torch.cumsum(pred.to(torch.int32), dim=0) - pred.to(torch.int32)
    where = torch.where(pred & (cnt < slots), cnt, slots).long().permute(1, 2, 0)

    def ring(vals: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        out = torch.zeros((s, r, slots + 1), dtype=dtype, device=vals.device)
        out.scatter_(2, where, vals.permute(1, 2, 0).to(dtype))
        return out[..., :slots]

    fr_ev, fr_node, fr_t = ring(ev, torch.int32), ring(node, torch.int32), ring(rec, torch.float32)
    fr_n = pred.sum(dim=0).to(torch.int32)
    if r < K:
        pad = K - r
        fr_ev, fr_node, fr_t = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                                for x in (fr_ev, fr_node, fr_t))
        fr_n = torch.nn.functional.pad(fr_n, (0, pad))
    return fr_ev.contiguous(), fr_node.contiguous(), fr_t.contiguous(), fr_n.contiguous()


class BlameTape:
    """Latency credits of every lane (:class:`~.blame_grid.Credit`), in
    emission order."""

    def __init__(self, n_servers: int) -> None:
        self.n_servers = n_servers
        self.credits: list[Credit] = []

    def credit(self, cell: int, secs: torch.Tensor, pred: torch.Tensor, *, off: int = 0,
               n: int | None = None) -> None:
        """``secs`` where ``pred`` into ``cell``; ``off`` / ``n``: the
        credit is of the lanes ``off ..`` of an n-lane row (a stream's
        entry chain), zero elsewhere."""
        val = torch.where(pred, secs, 0.0).to(torch.float32)
        if n is not None and n != val.shape[1]:
            full = torch.zeros((val.shape[0], n), dtype=torch.float32, device=val.device)
            full[:, off:off + val.shape[1]] = val
            val = full
        self.credits.append(Credit(val, cell=int(cell)))

    def credit_slots(self, cells: list[int], slot: torch.Tensor, secs: torch.Tensor,
                     pred: torch.Tensor) -> None:
        """``secs`` where ``pred`` into the cell of each lane's ``slot``."""
        val = torch.where(pred, secs, 0.0).to(torch.float32)
        pick = torch.where(pred, slot, 0).clamp_min(0).to(torch.uint8)
        self.credits.append(Credit(val, slot=pick, slot_cells=tuple(int(c) for c in cells)))

    def transit(self, eidx: int) -> int:
        """The transit cell of edge ``eidx``."""
        return bl.cell(bl.comp_edge(self.n_servers, eidx), bl.PH_TRANSIT)

    def server(self, s: int, phase: int) -> int:
        """The cell of server ``s``'s ``phase``."""
        return bl.cell(bl.comp_server(s), phase)


def blame_store(credits: list[Credit], success: torch.Tensor, n_cells: int) -> torch.Tensor:
    """(S, n, n_cells) float32 per-request rows of the successful lanes,
    compacted to the front in lane order (the reference's ``bl_store``, the
    conservation witness): each credit added in float32, credit by credit."""
    s, n = success.shape
    rows = torch.zeros((s, n, n_cells), dtype=torch.float32, device=success.device)
    for c in credits:
        cells = c.cells()
        idx = (torch.full((s, n), cells, dtype=torch.int64, device=success.device)
               if isinstance(cells, int) else cells)
        rows.scatter_add_(2, idx[..., None], torch.where(success, c.secs, 0.0)[..., None])
    ones = success.to(torch.int64)
    at = torch.where(success, torch.cumsum(ones, dim=1) - 1, n)
    out = torch.zeros((s, n + 1, n_cells), dtype=torch.float32, device=success.device)
    out.scatter_(1, at[..., None].expand(s, n, n_cells), rows)
    return out[:, :n]
