"""Stable time ranks of (S, n) rows, and small-table searches: the port of
the reference's ``engines/jaxsim/sortutil.py`` (``time_rank``,
``argsort_time``, ``searchsorted_small``).

The reference computes its rank in XLA (a single-operand ``lax.sort``, a
search and a tie fix), outside any Pallas kernel; its result is the
inverse of the stable argsort of ``where(alive, t, INF)`` with dead lanes
last in lane order.  Here that is one stable ``torch.sort`` of each row,
dead lanes keyed ``+inf`` (after every finite alive time; a stable sort
keeps them in lane order), and a scatter that inverts the permutation.
``-0.0`` is made ``+0.0`` first: the reference's comparator ties the two,
while a radix sort of the raw bits orders ``-0.0`` first.
"""

from __future__ import annotations

import torch


def argsort_time(t: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """(S, n) int64 stable argsort of each row of ``where(alive, t, inf)``."""
    key = torch.where(alive, torch.where(t == 0.0, 0.0, t), float("inf"))
    return torch.sort(key, dim=-1, stable=True).indices


def time_rank(t: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """(S, n) int64 rank of each lane in its row's stable time order: the
    inverse of :func:`argsort_time`.  Sort with a scatter
    (``sorted.scatter_(1, rank, x)`` is ``x`` in time order), un-sort with
    a gather (``sorted.gather(1, rank)``)."""
    perm = argsort_time(t, alive)
    lane = torch.arange(t.shape[-1], device=t.device).expand_as(perm)
    return torch.empty_like(perm).scatter_(-1, perm, lane)


def to_sorted(x: torch.Tensor, rank: torch.Tensor, fill) -> torch.Tensor:
    """``x`` (S, m) placed in rank order: ``full(fill).at[rank].set(x)``."""
    return torch.full_like(x, fill).scatter_(-1, rank, x)


def searchsorted_small(table: torch.Tensor, q: torch.Tensor, side: str) -> torch.Tensor:
    """Insertion index of ``q`` in a sorted ``table`` (int64): the count of
    entries ``<= q`` (``side="right"``) or ``< q`` (``"left"``), as
    ``jnp.searchsorted``.  ``table`` is (m,) or (S, m) with ``q`` (S, ...)."""
    if side not in ("left", "right"):
        msg = f"side must be 'left' or 'right', got {side!r}"
        raise ValueError(msg)
    if table.ndim == 1:
        return torch.bucketize(q, table, right=side == "right")
    return torch.searchsorted(table.contiguous(), q.contiguous(), right=side == "right")
