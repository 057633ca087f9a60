"""Full simulation input.

Same contract as the reference ``SimulationPayload`` for the fields this
slice models, event injection included: event ids are unique; each event
targets a declared server or edge of the right kind; windows sit inside
the horizon; at no instant are all servers down; outage windows on one
server never overlap.  ``rqs_input`` is one generator (the reference's
on-disk format) or a non-empty list of generators with unique ids, each
the source of exactly one entry edge; :attr:`SimulationPayload.generators`
is always the list.  The resilience blocks follow the reference's
cross-checks: a retry policy takes one generator; a fault's target is a
declared server (``server_outage``) or edge (the edge kinds) and its window
sits inside the horizon (overlapping fault windows are legal, and may
darken every server at once); a failure domain's targets are declared
servers or edges, and edge targets need degrade semantics.  Hedging is
refused by name.  PyYAML is imported only by :func:`load_payload`.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from asyncflow_tpu_torch.config.constants import EventDescription, FaultKind
from asyncflow_tpu_torch.errors import PayloadError
from asyncflow_tpu_torch.schemas._fields import as_list, read_fields
from asyncflow_tpu_torch.schemas.events import EventInjection
from asyncflow_tpu_torch.schemas.graph import TopologyGraph
from asyncflow_tpu_torch.schemas.resilience import FaultTimeline, HazardModel, RetryPolicy
from asyncflow_tpu_torch.schemas.settings import SimulationSettings
from asyncflow_tpu_torch.schemas.workload import RqsGenerator

_UNSUPPORTED_BLOCKS = ("hedge_policy",)


def _sweep_marks(
    windows: list[tuple[float, float, str]],
) -> list[tuple[float, bool, str]]:
    """(time, is_start, tag) marks of (t_start, t_end, tag) windows, END
    before START on time ties (back-to-back windows are legal)."""
    marks = [(t0, True, tag) for t0, _, tag in windows]
    marks += [(t1, False, tag) for _, t1, tag in windows]
    return sorted(marks, key=lambda mark: (mark[0], mark[1]))


@dataclass
class SimulationPayload:
    """Everything needed to run one scenario family."""

    rqs_input: RqsGenerator | list[RqsGenerator]
    topology_graph: TopologyGraph
    sim_settings: SimulationSettings
    events: list[EventInjection] | None = None
    #: the client's timeout / retry / backoff / budget discipline
    retry_policy: RetryPolicy | None = None
    #: scheduled fault windows (server outages, edge degradation or partition)
    fault_timeline: FaultTimeline | None = None
    #: a chaos campaign, sampled into per-scenario fault tables
    hazard_model: HazardModel | None = None

    @property
    def generators(self) -> list[RqsGenerator]:
        """The workload sources, always as a list."""
        if isinstance(self.rqs_input, RqsGenerator):
            return [self.rqs_input]
        return self.rqs_input

    def __post_init__(self) -> None:
        if isinstance(self.rqs_input, list):
            # the reference's _generators_nonempty_unique
            if not self.rqs_input:
                msg = "rqs_input must contain at least one generator"
                raise PayloadError(msg)
            ids = [gen.id for gen in self.rqs_input]
            if len(set(ids)) != len(ids):
                dup = sorted({i for i in ids if ids.count(i) > 1})
                msg = f"duplicate generator ids: {dup}"
                raise PayloadError(msg)
        graph = self.topology_graph
        node_ids = graph.declared_node_ids()
        for gen in self.generators:
            if gen.id in node_ids:
                msg = f"generator id {gen.id!r} collides with a node id"
                raise PayloadError(msg)
            outs = [e for e in graph.edges if e.source == gen.id]
            if len(outs) != 1:
                msg = (
                    f"generator {gen.id!r} must source exactly one edge, "
                    f"found {len(outs)}"
                )
                raise PayloadError(msg)
        self._check_resilience()
        if self.events is not None:
            self._check_events()

    def _check_resilience(self) -> None:
        """The reference's retry, fault and hazard cross-checks."""
        if self.retry_policy is not None and len(self.generators) > 1:
            msg = (
                "retry_policy with multiple generators is not supported yet: re-issues "
                "would need per-request entry-chain state; model the superposition as one "
                "generator or drop the retry policy"
            )
            raise PayloadError(msg)
        server_ids = {server.id for server in self.topology_graph.nodes.servers}
        edge_ids = {edge.id for edge in self.topology_graph.edges}
        horizon = float(self.sim_settings.total_simulation_time)
        for fault in self.fault_timeline.events if self.fault_timeline else []:
            if fault.kind == FaultKind.SERVER_OUTAGE:
                if fault.target_id not in server_ids:
                    msg = (f"fault {fault.fault_id!r}: server_outage target "
                           f"{fault.target_id!r} is not a declared server")
                    raise PayloadError(msg)
            elif fault.target_id not in edge_ids:
                msg = (f"fault {fault.fault_id!r}: {fault.kind} target {fault.target_id!r} "
                       "is not a declared edge")
                raise PayloadError(msg)
            if fault.t_start > horizon or fault.t_end > horizon:
                msg = (f"fault {fault.fault_id!r}: window [{fault.t_start}, {fault.t_end}] "
                       f"exceeds the simulation horizon T={horizon}")
                raise PayloadError(msg)
        for domain in self.hazard_model.domains if self.hazard_model else []:
            for target in domain.targets:
                if target not in server_ids and target not in edge_ids:
                    msg = (f"failure domain {domain.domain_id!r}: target {target!r} is not "
                           "a declared server or edge")
                    raise PayloadError(msg)
            edge_targets = [t for t in domain.targets if t in edge_ids]
            if edge_targets and domain.latency_factor == 1.0 and domain.dropout_boost == 0.0:
                msg = (f"failure domain {domain.domain_id!r}: edge targets {edge_targets} "
                       "need latency_factor > 1 and/or dropout_boost > 0")
                raise PayloadError(msg)

    def _check_events(self) -> None:
        """The reference's event validators, in its order."""
        events = self.events
        ids = [event.event_id for event in events]
        if len(ids) != len(set(ids)):
            msg = "The id's representing different events must be unique"
            raise PayloadError(msg)
        server_ids = {server.id for server in self.topology_graph.nodes.servers}
        edge_ids = {edge.id for edge in self.topology_graph.edges}
        for event in events:
            if event.target_id not in server_ids | edge_ids:
                msg = (
                    f"The target id {event.target_id} related to "
                    f"the event {event.event_id} does not exist"
                )
                raise PayloadError(msg)
        horizon = float(self.sim_settings.total_simulation_time)
        for event in events:
            t_start, t_end = event.start.t_start, event.end.t_end
            if t_start > horizon:
                msg = (
                    f"Event '{event.event_id}': start time t_start={t_start:.6f} "
                    f"exceeds simulation horizon T={horizon:.6f}"
                )
                raise PayloadError(msg)
            if t_end > horizon:
                msg = (
                    f"Event '{event.event_id}': end time t_end={t_end:.6f} "
                    f"exceeds simulation horizon T={horizon:.6f}"
                )
                raise PayloadError(msg)
        for event in events:
            kind = event.start.kind
            if kind == EventDescription.SERVER_DOWN and event.target_id not in server_ids:
                msg = (
                    f"The event {event.event_id} regarding a server does not have "
                    "a compatible target id"
                )
                raise PayloadError(msg)
            if kind == EventDescription.NETWORK_SPIKE_START and event.target_id not in edge_ids:
                msg = (
                    f"The event {event.event_id} regarding an edge does not have "
                    "a compatible target id"
                )
                raise PayloadError(msg)
        outages = [
            (event.start.t_start, event.end.t_end, event.target_id)
            for event in events
            if event.start.kind == EventDescription.SERVER_DOWN
            and event.target_id in server_ids
        ]
        down: set[str] = set()
        for time, is_start, server_id in _sweep_marks(outages):
            if not is_start:
                down.discard(server_id)
                continue
            down.add(server_id)
            if len(down) == len(server_ids):
                msg = f"At time {time:.6f} all servers are down; keep at least one up"
                raise PayloadError(msg)
        for server_id in dict.fromkeys(sid for _, _, sid in outages):
            active = 0
            windows = [w for w in outages if w[2] == server_id]
            for time, is_start, _ in _sweep_marks(windows):
                if not is_start:
                    active = max(0, active - 1)
                    continue
                if active >= 1:
                    msg = (
                        f"Overlapping events for server '{server_id}' at "
                        f"t={time:.6f}; server outage windows must not overlap."
                    )
                    raise PayloadError(msg)
                active += 1

    @classmethod
    def from_dict(cls, data: object) -> SimulationPayload:
        f = read_fields(
            data,
            "payload",
            known=("rqs_input", "topology_graph", "sim_settings", "events", "retry_policy",
                   "fault_timeline", "hazard_model"),
            required=("rqs_input", "topology_graph", "sim_settings"),
            unsupported=_UNSUPPORTED_BLOCKS,
        )
        rqs = f["rqs_input"]
        return cls(
            rqs_input=(
                [RqsGenerator.from_dict(g) for g in rqs]
                if isinstance(rqs, list)
                else RqsGenerator.from_dict(rqs)
            ),
            topology_graph=TopologyGraph.from_dict(f["topology_graph"]),
            sim_settings=SimulationSettings.from_dict(f["sim_settings"]),
            events=(
                None
                if f.get("events") is None
                else [EventInjection.from_dict(e) for e in as_list(f["events"], "events")]
            ),
            **{
                name: None if f.get(name) is None else block.from_dict(f[name])
                for name, block in (("retry_policy", RetryPolicy),
                                    ("fault_timeline", FaultTimeline),
                                    ("hazard_model", HazardModel))
            },
        )


def load_payload(path: str | Path) -> SimulationPayload:
    """Read a YAML scenario file (needs PyYAML; the sweep path does not)."""
    import yaml

    with Path(path).open(encoding="utf-8") as fh:
        return SimulationPayload.from_dict(yaml.safe_load(fh))
