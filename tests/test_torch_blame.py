"""The blame plane and the flight recorder on the retry payload (deadlines,
retries, a dark window: ``torch_plane_cases``) against the jitted JAX
``FastEngine`` with both planes on; the plain ``blame_grid`` against
``np.add.at``; the port's blame and trace helpers against the reference's;
and the sweep's planes: chunking, the report's decoders and breakdowns,
and the refusals of the engines that run neither plane."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_fast_cases import (  # noqa: F401 - torch_inference_mode: an autouse fixture
    example,
    mutated,
    one_torch_thread,
    torch_inference_mode,
)
from torch_plane_cases import check_blame, check_rings, runs

from asyncflow_tpu_torch.engines.torchsim.blame_grid import (
    BlameGrid,
    Credit,
    blame_grid_plain,
    blame_layout,
)
from asyncflow_tpu_torch.errors import PayloadError, UnsupportedFeatureError
from asyncflow_tpu_torch.observability import TraceConfig, decode_flight, flight_dropped_events
from asyncflow_tpu_torch.observability import blame as bl
from asyncflow_tpu_torch.observability import simtrace as st
from asyncflow_tpu_torch.parallel import SweepRunner

one_torch_thread()

RETRY_CODES = {st.FR_SPAWN, st.FR_TRANSIT, st.FR_ARRIVE_SRV, st.FR_WAIT_RAM, st.FR_WAIT_CPU,
               st.FR_RUN, st.FR_RETRY, st.FR_TIMEOUT, st.FR_DROP, st.FR_REJECT,
               st.FR_COMPLETE, st.FR_ABANDON}


@pytest.fixture(scope="module")
def retry():
    return runs("retry")


def test_retry_rings_equal_the_jitted_reference(retry) -> None:
    ref, got = retry["ref"], retry["port"]
    check_rings(ref, got, retry["slots"])
    assert set(np.unique(got.fr_ev).tolist()) - {0} == RETRY_CODES
    # the rings of retried requests overflow: the overflow is counted
    assert np.sum(got.fr_n > retry["slots"]) > 0
    for field in ("hist", "lat_count", "n_timed_out", "n_retries", "n_budget_exhausted",
                  "att_hist", "n_rejected", "n_dark_lost", "clock"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(ref, field)), err_msg=field)


def test_retry_blame_equals_the_jitted_reference(retry) -> None:
    check_blame(retry["ref"], retry["port"])


def test_a_logical_request_keeps_its_record_across_attempts(retry) -> None:
    got = retry["port"]
    rec = decode_flight(got.fr_ev[0], got.fr_node[0], got.fr_t[0], got.fr_n[0])
    retried = [r for r in rec.values() if st.FR_RETRY in r.codes()]
    assert retried
    # a re-issue opens its attempt block with a spawn (the last relaxation
    # pass may withdraw one, as the reference's does), and a retry names
    # the failed attempt
    assert any(r.codes().count(st.FR_SPAWN) >= 2 for r in retried)
    for r in retried:
        assert r.codes()[0] == st.FR_SPAWN
        nodes = [n for c, n, _t in r.events if c == st.FR_RETRY]
        assert nodes == sorted(nodes) and nodes[0] == 1
    assert flight_dropped_events(rec) == int(np.maximum(got.fr_n[0] - got.fr_ev.shape[2],
                                                        0).sum())


def _credits(rng, s, n, n_cells, kinds):
    out = []
    for kind in kinds:
        secs = torch.from_numpy(rng.random((s, n), np.float32) * 0.01)
        secs = torch.where(torch.from_numpy(rng.random((s, n)) < 0.3), 0.0, secs)
        if kind == "static":
            out.append(Credit(secs, cell=int(rng.integers(n_cells))))
        elif kind == "empty":
            out.append(Credit(torch.zeros_like(secs), cell=int(rng.integers(n_cells))))
        else:
            cells = tuple(int(c) for c in rng.integers(0, n_cells, 3))
            slot = torch.from_numpy(rng.integers(0, 3, (s, n)))
            out.append(Credit(secs, slot=slot, slot_cells=cells))
    return out


@pytest.mark.parametrize(("s", "n", "kinds"), [
    (2, 50, ("static",)),
    (3, 1000, ("static", "slots", "static", "empty")),
    (1, 1, ("slots",)),
    (4, 333, ("empty", "empty")),
])
def test_plain_blame_grid_matches_add_at(s: int, n: int, kinds: tuple) -> None:
    rng = np.random.default_rng(n + len(kinds))
    n_cells, nbb = 36, 64
    credits = _credits(rng, s, n, n_cells, kinds)
    # out-of-range targets (failed requests) drop
    target = torch.from_numpy(rng.integers(-2, nbb + 3, (s, n)))
    latency = torch.from_numpy(rng.random((s, n), np.float32))
    grid, lat = BlameGrid().reduce(credits, target, latency, n_cells, nbb)
    want = np.zeros((s, n_cells, nbb))
    want_lat = np.zeros((s, nbb))
    tgt = target.numpy()
    rows = np.broadcast_to(np.arange(s)[:, None], (s, n))
    live = (tgt >= 0) & (tgt < nbb)
    for c in credits:
        cells = np.broadcast_to(np.asarray(c.cells()), (s, n))
        np.add.at(want, (rows[live], cells[live], tgt[live]), c.secs.numpy()[live].astype(np.float64))
    np.add.at(want_lat, (rows[live], tgt[live]), latency.numpy()[live].astype(np.float64))
    np.testing.assert_array_equal(grid.numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(lat.numpy(), want_lat.astype(np.float32))
    assert grid.dtype == torch.float32 and lat.shape == (s, nbb)


def test_blame_layout_gives_each_cell_one_row() -> None:
    z = torch.zeros((1, 4))
    credits = [Credit(z, cell=7), Credit(z, slot=torch.zeros((1, 4), dtype=torch.int64),
                                         slot_cells=(3, 7, 9)), Credit(z, cell=3)]
    row_cell, cand_row, slot_row = blame_layout(credits)
    assert row_cell == [7, 3, 9, -1]
    assert cand_row == [0, 0, 1]
    assert slot_row == [1, 0, 2]


def test_blame_helpers_equal_the_reference() -> None:
    from asyncflow_tpu.observability import blame as ref_bl

    rng = np.random.default_rng(3)
    assert bl.PHASE_NAMES == ref_bl.PHASE_NAMES and bl.N_PHASES == ref_bl.N_PHASES
    for fine in (1024, 100, 64, 33):
        assert bl.n_blame_bins(fine) == ref_bl.n_blame_bins(fine)
        np.testing.assert_array_equal(bl.blame_edges(fine), ref_bl.blame_edges(fine))
        hist = rng.integers(0, 50, fine)
        np.testing.assert_array_equal(bl.coarse_counts(hist), ref_bl.coarse_counts(hist))
    hist = rng.integers(0, 50, 1024)
    grid = rng.random((bl.n_cells(2, 6), 64))
    for q, tail in ((0.5, False), (0.95, True), (0.99, False)):
        want = ref_bl.blame_breakdown(grid, hist, n_servers=2, n_edges=6,
                                      server_ids=["a", "b"], edge_ids=list("cdefgh"),
                                      q=q, tail=tail)
        got = bl.blame_breakdown(grid, hist, n_servers=2, n_edges=6, server_ids=["a", "b"],
                                 edge_ids=list("cdefgh"), q=q, tail=tail)
        assert got.__dict__ == want.__dict__
    assert bl.blame_shares(grid) == ref_bl.blame_shares(grid)


def test_trace_config_and_decoders_equal_the_reference() -> None:
    from asyncflow_tpu.observability import simtrace as ref_st

    assert st.FR_NAMES == ref_st.FR_NAMES
    assert TraceConfig() == TraceConfig.from_dict({})
    ref_cfg = ref_st.TraceConfig()
    assert (TraceConfig().sample_requests, TraceConfig().event_slots) == (
        ref_cfg.sample_requests, ref_cfg.event_slots)
    for bad in ({"sample_requests": 0}, {"sample_requests": 4097}, {"event_slots": 3},
                {"event_slots": 5000}, {"sample_requests": 2.0}, {"slots": 4}):
        with pytest.raises(PayloadError):
            TraceConfig.from_dict(bad)
    rng = np.random.default_rng(5)
    ev = rng.integers(1, 15, (4, 6))
    node = rng.integers(-1, 4, (4, 6))
    t = rng.random((4, 6)).astype(np.float32)
    n = np.array([0, 3, 6, 9])
    got = decode_flight(ev, node, t, n)
    want = ref_st.decode_flight(ev, node, t, n)
    assert {k: (v.events, v.dropped) for k, v in got.items()} == {
        k: (v.events, v.dropped) for k, v in want.items()}
    assert flight_dropped_events(got) == ref_st.flight_dropped_events(want) == 3
    assert got[3].describe(server_ids=["s"], edge_ids=list("abcd")) == want[3].describe(
        server_ids=["s"], edge_ids=list("abcd"))


def test_sweep_planes_survive_chunking() -> None:
    data = example("two_servers_lb", horizon=8)
    trace = {"sample_requests": 4, "event_slots": 6}
    one = SweepRunner(data, device="cpu", trace=trace, blame=True).run(5, seed=2, chunk_size=5)
    many = SweepRunner(data, device="cpu", trace=TraceConfig(**trace), blame=True).run(
        5, seed=2, chunk_size=2)
    res_1, res_n = one.results, many.results
    for name in ("flight_ev", "flight_node", "flight_t", "flight_n", "blame_rows",
                 "blame_lat_rows", "latency_hist"):
        np.testing.assert_array_equal(getattr(res_n, name), getattr(res_1, name))
    for name in ("blame_hist", "blame_lat_hist"):
        np.testing.assert_allclose(getattr(res_n, name), getattr(res_1, name), rtol=1e-12)
        assert getattr(res_n, name).dtype == np.float64
    np.testing.assert_array_equal(many.flight_dropped_events(),
                                  np.maximum(res_n.flight_n - 6, 0).sum(axis=1))
    assert many.flight_records(1) and many.flight_records(1)[0].codes()[0] == st.FR_SPAWN
    summary = many.summary()
    shares = {k[len("blame_share_"):]: v for k, v in summary.items()
              if k.startswith("blame_share_")}
    assert set(shares) == set(bl.PHASE_NAMES)
    assert abs(sum(shares.values()) - 1.0) < 1e-9 and shares["transit"] > 0
    report = many.latency_blame(95)
    assert report.bin_lo_s < report.bin_hi_s and report.n_requests > 0
    assert abs(sum(report.phase_shares.values()) - 1.0) < 1e-9
    tail = many.latency_blame(0.95, tail=True)
    assert tail.n_requests >= report.n_requests
    plain = SweepRunner(data, device="cpu").run(5, seed=2, chunk_size=2)
    assert plain.results.flight_ev is None and plain.results.blame_hist is None
    assert not any(k.startswith("blame_share_") for k in plain.summary())
    for fn in (plain.flight_dropped_events, lambda: plain.flight_records(0),
               plain.latency_blame):
        with pytest.raises(ValueError, match="collected"):
            fn()
    np.testing.assert_array_equal(plain.results.latency_hist, res_n.latency_hist)


@pytest.mark.parametrize("option", [{"trace": TraceConfig()}, {"blame": True}])
def test_engines_without_the_planes_refuse_them_by_name(option: dict) -> None:
    feature = "flight recorder" if "trace" in option else "latency blame"
    with pytest.raises(UnsupportedFeatureError, match=f"{feature}.*engine='kernel'"):
        SweepRunner(example("two_servers_lb"), engine="kernel", device="cpu", **option)
    declined = mutated("heterogeneous_ram")
    with pytest.raises(UnsupportedFeatureError, match=f"{feature}.*declines"):
        SweepRunner(declined, device="cpu", **option)
    assert SweepRunner(declined, device="cpu").engine_kind == "kernel"


def test_latency_bin_is_the_jitted_references() -> None:
    """The fast path's latency bin (XLA's ``log`` at the lanes beside a bin
    edge) equals the jitted reference's ``latency_bin`` on random latencies
    and on every bin edge's float32 latency and its two neighbours either
    side; torch's ``log`` alone moves some of them."""
    import jax

    from asyncflow_tpu.engines.jaxsim.sampling import latency_bin as ref_bin
    from asyncflow_tpu_torch.engines.torchsim.draws import log_xla
    from asyncflow_tpu_torch.engines.torchsim.sampling import hist_constants, latency_bin

    lo, scale = hist_constants(1024)
    rng = np.random.default_rng(11)
    edges = np.exp(lo + np.arange(1025) / scale).astype(np.float32)
    below = np.nextafter(edges, np.float32(0))
    above = np.nextafter(edges, np.float32(np.inf))
    lat = np.concatenate([
        np.exp(rng.uniform(np.log(1e-7), np.log(2e3), 4000)).astype(np.float32),
        edges, below, above, np.nextafter(below, np.float32(0)),
        np.nextafter(above, np.float32(np.inf)), np.float32([0.0, 1e-6, 1e3, 5e3]),
    ])
    want = np.asarray(jax.jit(lambda x: ref_bin(x, lo, scale, 1024))(lat))
    t = torch.from_numpy(lat)
    np.testing.assert_array_equal(latency_bin(t, lo, scale, 1024, log=log_xla).numpy(), want)
    assert np.sum(latency_bin(t, lo, scale, 1024).numpy() != want) > 0
