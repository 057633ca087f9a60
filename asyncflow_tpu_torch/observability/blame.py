"""The latency blame plane's layout and host-side breakdowns (the
reference's ``observability/blame.py``).

Every completed request's end-to-end latency is split into additive
**phase** credits, each charged to the **component** (server, edge, or the
virtual client) where the time was spent, and summed into a grid keyed by
the request's coarse latency bin.

- ``blame``: ``(n_cells, n_blame_bins)`` seconds spent in cell ``comp *
  N_PHASES + phase`` by requests whose latency fell in coarse bin ``b``;
- ``blame_lat``: ``(n_blame_bins,)`` their total latency seconds, the
  conservation denominator: ``blame[:, b].sum() == blame_lat[b]`` within
  the pooled tolerance.

Per request, the credits sum to the latency within a few float32 ulps (the
credits are realised timestamp differences, the service credit the exact
remainder).  The reference's grids accumulate in float32 and drift by up to
~1e-4 relative; the port's ``blame_grid`` accumulates in float64 and rounds
once.  Gate pooled conservation at rtol 1e-3 and per-request conservation
at ~1e-5.

Coarse bins decimate the shared log-spaced latency histogram by a stride,
so per-bin request counts fall out of the fine histogram
(:func:`coarse_counts`).  ``backoff`` and ``dark`` are reserved phases:
under attempt-scoped latency a completed attempt holds neither.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PH_Q_CPU = 0  # CPU ready-queue wait (core contention)
PH_Q_RAM = 1  # RAM admission wait
PH_Q_DB = 2  # DB connection-pool wait
PH_Q_ADMIT = 3  # serving batch-admission wait
PH_SERVICE = 4  # CPU bursts + plain/cache/LLM IO sleeps
PH_PREFILL = 5  # serving prefill sleep
PH_DECODE = 6  # serving decode sleep
PH_KV_REDO = 7  # repeated prefill after a KV eviction
PH_TRANSIT = 8  # edge traversal (latency + spikes + fault factors)
PH_BACKOFF = 9  # reserved: client retry backoff (zero today)
PH_HEDGE = 10  # winning duplicate's wait from anchor start to hedge fire
PH_DARK = 11  # reserved: dark-window loss (zero today)

N_PHASES = 12

PHASE_NAMES = (
    "q_cpu",
    "q_ram",
    "q_db",
    "q_admit",
    "service",
    "prefill",
    "decode",
    "kv_redo",
    "transit",
    "backoff",
    "hedge",
    "dark",
)

#: target coarse-bin count; the actual count divides the fine histogram
BLAME_BINS = 64


def blame_stride(n_hist_bins: int) -> int:
    """Fine bins a coarse bin."""
    return max(1, n_hist_bins // BLAME_BINS)


def n_blame_bins(n_hist_bins: int) -> int:
    """Coarse latency bins of an ``n_hist_bins``-bin fine histogram."""
    stride = blame_stride(n_hist_bins)
    return -(-n_hist_bins // stride)


def n_components(n_servers: int, n_edges: int) -> int:
    """Servers, then edges, then the virtual client."""
    return n_servers + n_edges + 1


def comp_server(s: int) -> int:
    return s


def comp_edge(n_servers: int, e: int) -> int:
    return n_servers + e


def comp_client(n_servers: int, n_edges: int) -> int:
    return n_servers + n_edges


def n_cells(n_servers: int, n_edges: int) -> int:
    return n_components(n_servers, n_edges) * N_PHASES


def cell(comp: int, phase: int) -> int:
    """Flat grid row of ``(component, phase)``."""
    return comp * N_PHASES + phase


def component_names(server_ids, edge_ids) -> list[str]:
    """Component labels in index order (the client last)."""
    return [*server_ids, *edge_ids, "client"]


def blame_edges(n_hist_bins: int) -> np.ndarray:
    """Coarse latency-bin edges (seconds): every ``stride``-th fine edge."""
    from asyncflow_tpu_torch.engines.torchsim.params import hist_edges

    fine = hist_edges(n_hist_bins)
    stride = blame_stride(n_hist_bins)
    idx = np.arange(0, n_hist_bins, stride)
    return np.append(fine[idx], fine[-1])


def coarse_counts(hist: np.ndarray) -> np.ndarray:
    """Completions a coarse bin, from the fine latency histogram."""
    hist = np.asarray(hist, dtype=np.float64)
    n = hist.shape[-1]
    stride = blame_stride(n)
    nb = n_blame_bins(n)
    pad = nb * stride - n
    if pad:
        hist = np.concatenate([hist, np.zeros((*hist.shape[:-1], pad), np.float64)], axis=-1)
    return hist.reshape(*hist.shape[:-1], nb, stride).sum(axis=-1)


def phase_grid(blame: np.ndarray, n_servers: int, n_edges: int) -> np.ndarray:
    """A flat ``(n_cells, B)`` grid as ``(n_comp, N_PHASES, B)``."""
    blame = np.asarray(blame, dtype=np.float64)
    return blame.reshape(n_components(n_servers, n_edges), N_PHASES, -1)


def _shares(totals: np.ndarray) -> np.ndarray:
    denom = float(totals.sum())
    if denom <= 0.0:
        return np.zeros_like(totals, dtype=np.float64)
    return np.asarray(totals, dtype=np.float64) / denom


@dataclass
class BlameReport:
    """One quantile's (or tail's) latency decomposition: shares of the
    attributed seconds in the selected coarse bins (summing to 1 where any
    time was attributed); ``bin_lo_s`` / ``bin_hi_s`` bound the bins."""

    q: float
    tail: bool
    bin_lo_s: float
    bin_hi_s: float
    n_requests: float
    total_s: float
    phase_shares: dict[str, float]
    component_shares: dict[str, float]
    cells: list[tuple[str, str, float]]  # (component, phase, share), descending

    def top(self, k: int = 5) -> list[tuple[str, str, float]]:
        return self.cells[:k]


def quantile_coarse_bin(hist: np.ndarray, q: float) -> int:
    """Coarse bin holding the pooled ``q``-quantile of the fine histogram."""
    counts = coarse_counts(np.asarray(hist, dtype=np.float64))
    total = counts.sum()
    if total <= 0:
        return 0
    cum = np.cumsum(counts)
    return int(np.searchsorted(cum, q * total, side="left").clip(0, len(counts) - 1))


def blame_breakdown(
    blame: np.ndarray,
    hist: np.ndarray,
    *,
    n_servers: int,
    n_edges: int,
    server_ids,
    edge_ids,
    q: float = 0.95,
    tail: bool = False,
    min_share: float = 1e-4,
) -> BlameReport:
    """Decompose latency at (``tail=False``: the coarse bin holding the
    pooled ``q``-quantile) or above (``tail=True``: every bin from it up)
    the quantile."""
    grid = phase_grid(blame, n_servers, n_edges)
    nb = grid.shape[-1]
    edges = blame_edges(np.asarray(hist).shape[-1])
    b = quantile_coarse_bin(hist, q)
    sel = slice(b, nb) if tail else slice(b, b + 1)
    cell_s = grid[:, :, sel].sum(axis=-1)
    counts = coarse_counts(hist)[sel].sum()
    names = component_names(server_ids, edge_ids)
    flat = _shares(cell_s).ravel()
    order = np.argsort(flat)[::-1]
    return BlameReport(
        q=q,
        tail=tail,
        bin_lo_s=float(edges[b]),
        bin_hi_s=float(edges[-1] if tail else edges[b + 1]),
        n_requests=float(counts),
        total_s=float(cell_s.sum()),
        phase_shares=dict(zip(PHASE_NAMES, _shares(cell_s.sum(axis=0)))),
        component_shares=dict(zip(names, _shares(cell_s.sum(axis=1)))),
        cells=[(names[k // N_PHASES], PHASE_NAMES[k % N_PHASES], float(flat[k]))
               for k in order if flat[k] >= min_share],
    )


def blame_shares(blame: np.ndarray) -> dict[str, float]:
    """Whole-run phase shares (``summary()`` keys ``blame_share_<phase>``)."""
    grid = np.asarray(blame, dtype=np.float64)
    ncomp = grid.shape[0] // N_PHASES
    totals = grid.reshape(ncomp, N_PHASES, -1).sum(axis=(0, 2))
    return dict(zip(PHASE_NAMES, _shares(totals)))
