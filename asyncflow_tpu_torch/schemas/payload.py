"""Full simulation input.

Same contract as the reference ``SimulationPayload`` for the fields this
slice models.  Event injection, the resilience blocks (retry policy, fault
timeline, hedging, hazard model) and multi-generator workloads are refused
by name.  PyYAML is imported only by :func:`load_payload`.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from asyncflow_tpu_torch.errors import PayloadError, UnsupportedFeatureError
from asyncflow_tpu_torch.schemas._fields import read_fields
from asyncflow_tpu_torch.schemas.graph import TopologyGraph
from asyncflow_tpu_torch.schemas.settings import SimulationSettings
from asyncflow_tpu_torch.schemas.workload import RqsGenerator

_UNSUPPORTED_BLOCKS = (
    "events",
    "retry_policy",
    "fault_timeline",
    "hedge_policy",
    "hazard_model",
)


@dataclass
class SimulationPayload:
    """Everything needed to run one scenario family."""

    rqs_input: RqsGenerator
    topology_graph: TopologyGraph
    sim_settings: SimulationSettings

    def __post_init__(self) -> None:
        graph = self.topology_graph
        node_ids = graph.declared_node_ids()
        gen = self.rqs_input
        if gen.id in node_ids:
            msg = f"generator id {gen.id!r} collides with a node id"
            raise PayloadError(msg)
        outs = [e for e in graph.edges if e.source == gen.id]
        if len(outs) != 1:
            msg = f"generator {gen.id!r} must source exactly one edge, found {len(outs)}"
            raise PayloadError(msg)

    @classmethod
    def from_dict(cls, data: object) -> SimulationPayload:
        f = read_fields(
            data,
            "payload",
            known=("rqs_input", "topology_graph", "sim_settings"),
            required=("rqs_input", "topology_graph", "sim_settings"),
            unsupported=_UNSUPPORTED_BLOCKS,
        )
        rqs = f["rqs_input"]
        if isinstance(rqs, list):
            if len(rqs) != 1:
                raise UnsupportedFeatureError("multi_generator", "rqs_input")
            rqs = rqs[0]
        return cls(
            rqs_input=RqsGenerator.from_dict(rqs),
            topology_graph=TopologyGraph.from_dict(f["topology_graph"]),
            sim_settings=SimulationSettings.from_dict(f["sim_settings"]),
        )


def load_payload(path: str | Path) -> SimulationPayload:
    """Read a YAML scenario file (needs PyYAML; the sweep path does not)."""
    import yaml

    with Path(path).open(encoding="utf-8") as fh:
        return SimulationPayload.from_dict(yaml.safe_load(fh))
