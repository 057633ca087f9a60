"""Edge schema: a directed stochastic network link between two nodes.

Same contract as the reference: positive latency mean, non-negative
variance, dropout a probability (default 1%), no self-loops.
"""

from __future__ import annotations

from dataclasses import dataclass

from asyncflow_tpu_torch.config.constants import NetworkParameters, SystemEdges
from asyncflow_tpu_torch.errors import PayloadError
from asyncflow_tpu_torch.schemas._fields import (
    as_enum,
    as_float,
    as_str,
    check_range,
    read_fields,
)
from asyncflow_tpu_torch.schemas.random_variables import RVConfig


@dataclass
class Edge:
    """A directed connection in the topology graph."""

    id: str
    source: str
    target: str
    latency: RVConfig
    edge_type: SystemEdges = SystemEdges.NETWORK_CONNECTION
    dropout_rate: float = NetworkParameters.DROPOUT_RATE

    def __post_init__(self) -> None:
        self.id = as_str(self.id, "edge id")
        self.source = as_str(self.source, f"edge {self.id!r} source")
        self.target = as_str(self.target, f"edge {self.id!r} target")
        self.edge_type = as_enum(SystemEdges, self.edge_type, "edge_type")
        self.dropout_rate = as_float(self.dropout_rate, "dropout_rate")
        check_range(
            self.dropout_rate,
            f"edge {self.id!r} dropout_rate",
            ge=NetworkParameters.MIN_DROPOUT_RATE,
            le=NetworkParameters.MAX_DROPOUT_RATE,
        )
        if self.latency.mean <= 0:
            msg = f"The mean latency of the edge '{self.id}' must be positive"
            raise PayloadError(msg)
        if self.latency.variance is not None and self.latency.variance < 0:
            msg = f"The variance of the latency of the edge {self.id} must be non negative"
            raise PayloadError(msg)
        if self.source == self.target:
            msg = "source and target must be different nodes"
            raise PayloadError(msg)

    @classmethod
    def from_dict(cls, data: object) -> Edge:
        f = read_fields(
            data,
            "edge",
            known=("id", "source", "target", "latency", "edge_type", "dropout_rate"),
            required=("id", "source", "target", "latency"),
        )
        f["latency"] = RVConfig.from_dict(f["latency"], f"edge {f['id']!r} latency")
        return cls(**f)
