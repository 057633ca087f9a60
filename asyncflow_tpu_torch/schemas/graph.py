"""Topology graph schema with the reference's global consistency checks:
unique edge ids; every edge target is a declared node; external sources
(the generator) never appear as targets; the LB cover-set names declared
servers, each reachable by an LB edge; only the LB fans out.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

from asyncflow_tpu_torch.errors import PayloadError
from asyncflow_tpu_torch.schemas._fields import as_list, read_fields
from asyncflow_tpu_torch.schemas.edges import Edge
from asyncflow_tpu_torch.schemas.nodes import TopologyNodes


@dataclass
class TopologyGraph:
    """Directed graph of the whole system under simulation."""

    nodes: TopologyNodes
    edges: list[Edge]

    def __post_init__(self) -> None:
        self._unique_edge_ids()
        self._edge_refs_valid()
        self._valid_load_balancer()
        self._no_fanout_except_lb()

    @classmethod
    def from_dict(cls, data: object) -> TopologyGraph:
        f = read_fields(
            data, "topology_graph", known=("nodes", "edges"), required=("nodes", "edges"),
        )
        return cls(
            nodes=TopologyNodes.from_dict(f["nodes"]),
            edges=[Edge.from_dict(e) for e in as_list(f["edges"], "edges")],
        )

    def declared_node_ids(self) -> set[str]:
        ids = {server.id for server in self.nodes.servers}
        ids.add(self.nodes.client.id)
        if self.nodes.load_balancer is not None:
            ids.add(self.nodes.load_balancer.id)
        return ids

    def _unique_edge_ids(self) -> None:
        duplicates = [
            edge_id
            for edge_id, count in Counter(edge.id for edge in self.edges).items()
            if count > 1
        ]
        if duplicates:
            msg = f"There are multiple edges with the following ids {duplicates}"
            raise PayloadError(msg)

    def _edge_refs_valid(self) -> None:
        node_ids = self.declared_node_ids()
        external_sources: set[str] = set()
        for edge in self.edges:
            if edge.target not in node_ids:
                msg = (
                    f"Edge {edge.source}->{edge.target} references "
                    f"unknown target node '{edge.target}'."
                )
                raise PayloadError(msg)
            if edge.source not in node_ids:
                external_sources.add(edge.source)
        forbidden = external_sources & {edge.target for edge in self.edges}
        if forbidden:
            msg = f"External IDs cannot be used as targets as well:{sorted(forbidden)}"
            raise PayloadError(msg)

    def _valid_load_balancer(self) -> None:
        lb = self.nodes.load_balancer
        if lb is None:
            return
        server_ids = {server.id for server in self.nodes.servers}
        missing = lb.server_covered - server_ids
        if missing:
            msg = f"Load balancer '{lb.id}' references unknown servers: {sorted(missing)}"
            raise PayloadError(msg)
        targets_from_lb = {edge.target for edge in self.edges if edge.source == lb.id}
        not_linked = lb.server_covered - targets_from_lb
        if not_linked:
            msg = (
                f"Servers {sorted(not_linked)} are covered by LB '{lb.id}' "
                "but have no outgoing edge from it."
            )
            raise PayloadError(msg)

    def _no_fanout_except_lb(self) -> None:
        lb = self.nodes.load_balancer
        lb_id = lb.id if lb is not None else None
        node_ids = self.declared_node_ids()
        out_degree = Counter(edge.source for edge in self.edges if edge.source in node_ids)
        offenders = [s for s, count in out_degree.items() if count > 1 and s != lb_id]
        if offenders:
            msg = (
                "Only the load balancer can have multiple outgoing edges. "
                f"Offending sources: {offenders}"
            )
            raise PayloadError(msg)
