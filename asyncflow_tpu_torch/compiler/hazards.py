"""Chaos campaigns: sample stochastic hazard models into per-scenario
piecewise fault tables.

The port's copy of the reference's ``compiler/hazards.py``: the numpy
lowering as it stands, and the lockstep uniforms drawn with the port's own
threefry (``engines/torchsim/keys.py``), which equal ``jax.random``'s bit
for bit, so the tables are the reference's exactly.

The hazard model (``schemas/resilience.py``: :class:`HazardModel` /
:class:`FailureDomain`) describes *random* failure processes — per-domain
MTBF/MTTR duration laws plus correlated blast groups — where the fault
timeline (``compiler/faults.py``) describes hand-authored windows.  This
module is the single lowering both worlds share:

- :func:`lower_hazards` turns the validated model into dense per-domain
  arrays carried on the :class:`~asyncflow_tpu_torch.compiler.plan.StaticPlan`
  (``hz_*`` fields), so every engine sees one description.
- :func:`hazard_fault_tables` samples scenario ``i``'s window recurrence
  with lockstep inverse-CDF draws keyed by
  ``fold_in(fold_in(fold_in(scenario_key, HZ_SITE + domain), ordinal),
  0|1)`` and merges them with the plan's static tables into ``(S, ...)``
  breakpoint tables of the exact shape the engines already consume.
  The draws are a pure function of ``(seed, global scenario index)`` —
  prefix-stable across chunking, and the same host-side numpy tables for
  every engine and for the reference package.
- the resilience-scorecard reducers (:func:`unavailable_seconds`,
  :func:`degraded_seconds_mask`, :func:`time_to_drain`) derive
  availability metrics from those tables so no engine needs new device
  counters for them.

Budget discipline: each (scenario, domain) samples ``2 * F`` window
ordinals but only the first ``F = max_faults_per_component`` enter the
tables (static shapes); later ordinals that would still start
inside the horizon are *counted* into ``truncated`` — the flight
recorder's explicit-truncation discipline, never silent.

Fold-site layout: ``HZ_SITE + d`` keeps hazard draws disjoint from every
other per-scenario family (generator streams 100000+g, retry jitter
2048+a, per-server families 64+s / 160+s).
"""

from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

#: fold_in site base for hazard draws — disjoint from every other
#: per-scenario-key fold family (see module docstring).
HZ_SITE = 200_000

#: duration-law codes, pinned to compiler.plan._DIST_IDS (asserted in
#: :func:`lower_hazards` so the two can never drift).
D_EXPONENTIAL = 2
D_NORMAL = 3
D_LOG_NORMAL = 4

_ndtri = np.vectorize(NormalDist().inv_cdf, otypes=[np.float64])


@dataclass
class HazardSpec:
    """The hazard model lowered to dense per-domain arrays (plan fields)."""

    mtbf_dist: np.ndarray  # (D,) i32 duration-law code
    mtbf_mean: np.ndarray  # (D,) f64
    mtbf_var: np.ndarray  # (D,) f64 (0 when the law has none)
    mttr_dist: np.ndarray  # (D,) i32
    mttr_mean: np.ndarray  # (D,) f64
    mttr_var: np.ndarray  # (D,) f64
    lat_factor: np.ndarray  # (D,) f64 edge latency multiplier
    drop_boost: np.ndarray  # (D,) f64 edge dropout boost
    srv_targets: np.ndarray  # (D, NS) i8 blast-group server membership
    edge_targets: np.ndarray  # (D, NE) i8 blast-group edge membership
    max_faults: int  # F: window slots per (scenario, domain)
    domain_ids: list[str]


def lower_hazards(payload) -> HazardSpec | None:
    """Lower the payload's hazard model against its topology order."""
    model = getattr(payload, "hazard_model", None)
    if model is None:
        return None
    from asyncflow_tpu_torch.compiler.plan import _DIST_IDS
    from asyncflow_tpu_torch.config.constants import Distribution

    assert _DIST_IDS[Distribution.EXPONENTIAL] == D_EXPONENTIAL
    assert _DIST_IDS[Distribution.NORMAL] == D_NORMAL
    assert _DIST_IDS[Distribution.LOG_NORMAL] == D_LOG_NORMAL

    servers = payload.topology_graph.nodes.servers
    edges = payload.topology_graph.edges
    server_index = {s.id: i for i, s in enumerate(servers)}
    edge_index = {e.id: i for i, e in enumerate(edges)}
    domains = model.domains
    n_dom = len(domains)

    spec = HazardSpec(
        mtbf_dist=np.zeros(n_dom, np.int32),
        mtbf_mean=np.zeros(n_dom, np.float64),
        mtbf_var=np.zeros(n_dom, np.float64),
        mttr_dist=np.zeros(n_dom, np.int32),
        mttr_mean=np.zeros(n_dom, np.float64),
        mttr_var=np.zeros(n_dom, np.float64),
        lat_factor=np.ones(n_dom, np.float64),
        drop_boost=np.zeros(n_dom, np.float64),
        srv_targets=np.zeros((n_dom, len(servers)), np.int8),
        edge_targets=np.zeros((n_dom, len(edges)), np.int8),
        max_faults=int(model.max_faults_per_component),
        domain_ids=[d.domain_id for d in domains],
    )
    for di, dom in enumerate(domains):
        spec.mtbf_dist[di] = _DIST_IDS[dom.mtbf.distribution]
        spec.mtbf_mean[di] = float(dom.mtbf.mean)
        spec.mtbf_var[di] = float(dom.mtbf.variance or 0.0)
        spec.mttr_dist[di] = _DIST_IDS[dom.mttr.distribution]
        spec.mttr_mean[di] = float(dom.mttr.mean)
        spec.mttr_var[di] = float(dom.mttr.variance or 0.0)
        spec.lat_factor[di] = float(dom.latency_factor)
        spec.drop_boost[di] = float(dom.dropout_boost)
        for target in dom.targets:
            if target in server_index:
                spec.srv_targets[di, server_index[target]] = 1
            elif target in edge_index:
                spec.edge_targets[di, edge_index[target]] = 1
            else:
                msg = (
                    f"failure domain {dom.domain_id!r}: target {target!r} "
                    "is not a declared server or edge"
                )
                raise ValueError(msg)
    return spec


def _hz_uniforms(seed: int, first: int, count: int, n_dom: int, n_ord: int):
    """(S, D, J, 2) lockstep uniforms for scenarios [first, first+count),
    float64 holding float32 values.

    The scenario key is ``fold_in(PRNGKey(seed), i)`` (the sweeps'
    :func:`~asyncflow_tpu_torch.engines.torchsim.keys.scenario_keys`), then
    per (domain, ordinal): ``base = fold_in(fold_in(key, HZ_SITE + d), j)``
    and the (gap, duration) pair is the scalar ``jax.random.uniform`` of
    ``fold_in(base, 0|1)``: lane 0 of the key's stream.  Every index is a
    pure fold of the global scenario index: prefix-stable by construction.
    """
    import torch

    from asyncflow_tpu_torch.engines.torchsim.draws import uniform
    from asyncflow_tpu_torch.engines.torchsim.keys import fold_in, scenario_keys

    keys = scenario_keys(seed, count, first=first)
    kd = fold_in(keys[:, None, :], torch.arange(n_dom, dtype=torch.int64) + HZ_SITE)
    kj = fold_in(kd[:, :, None, :], torch.arange(n_ord, dtype=torch.int64))
    kp = fold_in(kj[:, :, :, None, :], torch.arange(2, dtype=torch.int64))
    u = uniform(kp.reshape(-1, 2), 1).reshape(count, n_dom, n_ord, 2)
    return u.numpy().astype(np.float64)


def _inv_cdf(dist: int, mean, var: float, u: np.ndarray) -> np.ndarray:
    """Inverse-CDF duration draw, matching ``samplers/variates.py``'s
    antithetic path exactly (the variance field IS the scale parameter,
    the vocabulary's documented quirk)."""
    if dist == D_EXPONENTIAL:
        return -mean * np.log1p(-u)
    if dist == D_NORMAL:
        return np.maximum(0.0, mean + var * _ndtri(u))
    if dist == D_LOG_NORMAL:
        return np.exp(mean + var * _ndtri(u))
    msg = f"unsupported hazard duration-law code: {dist}"
    raise ValueError(msg)


def sample_hazard_windows(
    plan,
    seed: int,
    first: int,
    count: int,
    hazard_scale=None,
    mttr_scale=None,
):
    """Sample each scenario's per-domain fault windows.

    Returns ``(starts, ends, truncated)``: ``(S, D, F)`` float64 window
    bounds (the in-budget ordinals) and the ``(S,)`` int64 count of
    in-horizon windows dropped by the slot budget.  ``hazard_scale``
    divides the MTBF mean (more chaos), ``mttr_scale`` multiplies the
    MTTR mean (slower repair); both reuse the SAME uniforms, so scale
    sweeps are CRN-paired by construction.
    """
    n_dom = int(plan.hz_mtbf_mean.shape[0])
    n_slots = int(plan.hz_max_faults)
    n_ord = 2 * n_slots
    u = np.clip(
        _hz_uniforms(seed, first, count, n_dom, n_ord),
        1e-12,
        1.0 - 1e-12,
    )
    hs = np.asarray(
        1.0 if hazard_scale is None else hazard_scale, np.float64,
    ).reshape(-1, 1)
    ms = np.asarray(
        1.0 if mttr_scale is None else mttr_scale, np.float64,
    ).reshape(-1, 1)
    gaps = np.empty((count, n_dom, n_ord), np.float64)
    durs = np.empty((count, n_dom, n_ord), np.float64)
    for d in range(n_dom):
        gaps[:, d, :] = _inv_cdf(
            int(plan.hz_mtbf_dist[d]),
            float(plan.hz_mtbf_mean[d]) / hs,
            float(plan.hz_mtbf_var[d]),
            u[:, d, :, 0],
        )
        durs[:, d, :] = _inv_cdf(
            int(plan.hz_mttr_dist[d]),
            float(plan.hz_mttr_mean[d]) * ms,
            float(plan.hz_mttr_var[d]),
            u[:, d, :, 1],
        )
    ends = np.cumsum(gaps + durs, axis=2)
    starts = ends - durs
    truncated = np.sum(
        starts[:, :, n_slots:] < float(plan.horizon), axis=(1, 2),
    ).astype(np.int64)
    return starts[:, :, :n_slots], ends[:, :, :n_slots], truncated


@dataclass
class HazardTables:
    """Per-scenario merged fault tables + the sampled windows behind them."""

    srv_times: np.ndarray  # (S, K) f32 sorted change times, [:, 0] == 0
    srv_down: np.ndarray  # (S, K, NS) i32
    edge_times: np.ndarray  # (S, M) f32
    edge_lat: np.ndarray  # (S, M, NE) f32 multiplicative
    edge_drop: np.ndarray  # (S, M, NE) f32 additive
    starts: np.ndarray  # (S, D, F) f64 sampled window starts
    ends: np.ndarray  # (S, D, F) f64 sampled window ends
    truncated: np.ndarray  # (S,) i64 in-horizon windows past the budget


def hazard_fault_tables(
    plan,
    seed: int,
    first: int,
    count: int,
    hazard_scale=None,
    mttr_scale=None,
) -> HazardTables:
    """Materialize scenarios [first, first+count)'s fault tables.

    The sampled windows are merged with the plan's static fault tables
    (union for server outages, multiplicative/additive superposition for
    edge degradation) into fixed-width per-scenario breakpoint tables —
    the exact piecewise-constant encoding every engine already evaluates
    (``compiler/faults.py``).  Rows are time-sorted per scenario with a
    stable order, so duplicate times resolve identically everywhere; the
    host/device lookup (``searchsorted(..., 'right') - 1``) reads the
    LAST row at a time, which carries the full superposed state.
    """
    starts, ends, truncated = sample_hazard_windows(
        plan, seed, first, count, hazard_scale, mttr_scale,
    )
    n_scn, n_dom, n_slots = starts.shape
    dom_of = np.repeat(np.arange(n_dom), n_slots)
    marks_t = np.concatenate(
        [starts.reshape(n_scn, -1), ends.reshape(n_scn, -1)], axis=1,
    )  # (S, 2DF): all starts, then all ends

    def merged(static_times, static_vals, hz_rows, combine):
        """One merged table: static breakpoints + per-scenario marks.

        ``hz_rows`` is the (2DF, W) per-mark delta matrix; ``combine``
        maps (static value rows, hazard cumulative rows) -> final rows.
        """
        k0 = static_times.shape[0]
        st64 = static_times.astype(np.float64)
        full_t = np.concatenate(
            [np.broadcast_to(st64, (n_scn, k0)), marks_t], axis=1,
        )
        full_delta = np.concatenate(
            [np.zeros((k0, hz_rows.shape[1]), np.float64), hz_rows], axis=0,
        )
        order = np.argsort(full_t, axis=1, kind="stable")
        sorted_t = np.take_along_axis(full_t, order, axis=1)
        hz_cum = np.cumsum(full_delta[order], axis=1)  # (S, K, W)
        sidx = np.maximum(
            np.searchsorted(st64, sorted_t.ravel(), side="right") - 1, 0,
        ).reshape(n_scn, -1)
        return sorted_t.astype(np.float32), combine(static_vals[sidx], hz_cum)

    # ---- server outage table: union of static windows + hazard windows
    srv_rows = np.concatenate(
        [
            plan.hz_srv_targets[dom_of].astype(np.float64),
            -plan.hz_srv_targets[dom_of].astype(np.float64),
        ],
        axis=0,
    )
    srv_times, srv_down = merged(
        plan.fault_srv_times,
        plan.fault_srv_down,
        srv_rows,
        lambda static, cum: ((static != 0) | (cum > 0.5)).astype(np.int32),
    )

    # ---- edge degrade tables: factors multiply (via log sums), boosts add
    edge_w = plan.hz_edge_targets.shape[1]
    log_lat = np.log(plan.hz_lat_factor)[dom_of, None] * plan.hz_edge_targets[
        dom_of
    ].astype(np.float64)
    lat_rows = np.concatenate([log_lat, -log_lat], axis=0)
    drop = plan.hz_drop_boost[dom_of, None] * plan.hz_edge_targets[
        dom_of
    ].astype(np.float64)
    drop_rows = np.concatenate([drop, -drop], axis=0)

    def combine_lat(static, cum):
        lat = static.astype(np.float64) * np.exp(cum)
        # exp/log round trips can leave 1 +- eps outside windows; snap
        lat[np.isclose(lat, 1.0, atol=1e-6)] = 1.0
        return lat.astype(np.float32)

    edge_times, edge_lat = merged(
        plan.fault_edge_times, plan.fault_edge_lat, lat_rows, combine_lat,
    )
    edge_times2, edge_drop = merged(
        plan.fault_edge_times,
        plan.fault_edge_drop,
        drop_rows,
        lambda static, cum: np.clip(
            static.astype(np.float64) + cum, 0.0, None,
        ).astype(np.float32),
    )
    assert edge_w == edge_drop.shape[2]
    np.testing.assert_array_equal(edge_times, edge_times2)

    return HazardTables(
        srv_times=srv_times,
        srv_down=srv_down,
        edge_times=edge_times,
        edge_lat=edge_lat,
        edge_drop=edge_drop,
        starts=starts,
        ends=ends,
        truncated=truncated,
    )


# ----------------------------------------------------------------------
# resilience scorecard reducers (host-side, engine-agnostic: pure
# functions of the sampled tables + already-recorded series)
# ----------------------------------------------------------------------


def unavailable_seconds(
    srv_times: np.ndarray,
    srv_down: np.ndarray,
    horizon: float,
) -> np.ndarray:
    """(S, NS) float64 per-server dark seconds inside the horizon.

    Exact integral of the piecewise-constant outage table — identical for
    every engine because the tables are."""
    t = np.minimum(srv_times.astype(np.float64), horizon)
    n_scn = t.shape[0]
    t_next = np.concatenate(
        [t[:, 1:], np.full((n_scn, 1), float(horizon))], axis=1,
    )
    span = np.maximum(t_next - t, 0.0)
    return np.einsum("sk,skn->sn", span, srv_down.astype(np.float64))


def degraded_seconds_mask(
    tables: HazardTables,
    horizon: float,
    n_buckets: int,
) -> np.ndarray:
    """(S, T) bool: 1-second throughput bucket ``b`` overlaps some active
    fault state (server dark, edge degraded) — the denominator mask for
    degraded-window goodput."""
    n_scn = tables.srv_times.shape[0]
    buckets = np.arange(n_buckets, dtype=np.float64)

    def row_mask(times: np.ndarray, active: np.ndarray) -> np.ndarray:
        t = times.astype(np.float64)
        t_next = np.concatenate(
            [t[:, 1:], np.full((n_scn, 1), np.inf)], axis=1,
        )
        t0 = np.clip(t, 0.0, horizon)
        t1 = np.clip(t_next, 0.0, horizon)
        out = np.zeros((n_scn, n_buckets), bool)
        for k in range(t.shape[1]):
            act = active[:, k]
            if not act.any():
                continue
            out |= (
                act[:, None]
                & (t0[:, k, None] < buckets + 1.0)
                & (t1[:, k, None] > buckets)
            )
        return out

    srv_active = tables.srv_down.astype(bool).any(axis=2)
    edge_active = (tables.edge_lat != 1.0).any(axis=2) | (
        tables.edge_drop != 0.0
    ).any(axis=2)
    return row_mask(tables.srv_times, srv_active) | row_mask(
        tables.edge_times, edge_active,
    )


def window_span(
    tables: HazardTables,
    horizon: float,
) -> tuple[np.ndarray, np.ndarray]:
    """(first_start, last_end) of each scenario's in-horizon sampled
    windows, both (S,) float64 (NaN when the scenario sampled none)."""
    in_h = tables.starts < horizon
    starts = np.where(in_h, tables.starts, np.inf)
    ends = np.where(in_h, np.minimum(tables.ends, horizon), -np.inf)
    first = starts.min(axis=(1, 2))
    last = ends.max(axis=(1, 2))
    none = ~in_h.any(axis=(1, 2))
    first[none] = np.nan
    last[none] = np.nan
    return first, last


def time_to_drain(
    series: np.ndarray,
    period: float,
    first_start: np.ndarray,
    last_end: np.ndarray,
) -> np.ndarray:
    """(S,) sim-seconds from the last window closing until every tracked
    ready-queue series re-enters its pre-fault band (mean + 2 sigma of the
    samples before the first window).  NaN when undefined: no sampled
    window, no pre-fault samples, or the queue never returns inside the
    horizon."""
    series = np.asarray(series, np.float64)
    n_scn, n_t, _ = series.shape
    times = (np.arange(n_t, dtype=np.float64) + 1.0) * float(period)
    out = np.full(n_scn, np.nan)
    for s in range(n_scn):
        if not (np.isfinite(first_start[s]) and np.isfinite(last_end[s])):
            continue
        pre = series[s][times < first_start[s]]
        if pre.shape[0] == 0:
            continue
        band_hi = pre.mean(axis=0) + 2.0 * pre.std(axis=0) + 1e-9
        settled = (series[s] <= band_hi[None, :]).all(axis=1) & (
            times >= last_end[s]
        )
        if settled.any():
            out[s] = times[int(np.argmax(settled))] - last_end[s]
    return out
