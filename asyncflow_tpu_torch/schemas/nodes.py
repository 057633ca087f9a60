"""Node schemas of the topology graph: client, server (+ resources), LB.

Same contract as the reference: node ``type`` fields keep their standard
value, resources are bounded below (>= 1 core, >= 256 MB RAM) and node ids
are unique.  Overload policies, circuit breakers, LB health gates, serving
policies and DB connection pools are refused by name.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

from asyncflow_tpu_torch.config.constants import (
    LbAlgorithmsName,
    ServerResourcesDefaults,
    SystemNodes,
)
from asyncflow_tpu_torch.errors import PayloadError
from asyncflow_tpu_torch.schemas._fields import (
    as_enum,
    as_int,
    as_list,
    as_str,
    check_range,
    read_fields,
)
from asyncflow_tpu_torch.schemas.endpoint import Endpoint


def _fixed_type(value: object, expected: SystemNodes) -> SystemNodes:
    if value != expected:
        msg = f"The type should have a standard value: {expected}"
        raise PayloadError(msg)
    return expected


@dataclass
class Client:
    """Entry and exit point of every request."""

    id: str
    type: SystemNodes = SystemNodes.CLIENT

    def __post_init__(self) -> None:
        self.id = as_str(self.id, "client id")
        self.type = _fixed_type(self.type, SystemNodes.CLIENT)

    @classmethod
    def from_dict(cls, data: object) -> Client:
        return cls(**read_fields(data, "client", known=("id", "type"), required=("id",)))


@dataclass
class ServerResources:
    """Finite resources of one server."""

    cpu_cores: int = ServerResourcesDefaults.CPU_CORES
    ram_mb: int = ServerResourcesDefaults.RAM_MB

    def __post_init__(self) -> None:
        self.cpu_cores = as_int(self.cpu_cores, "cpu_cores")
        check_range(
            self.cpu_cores, "cpu_cores", ge=ServerResourcesDefaults.MINIMUM_CPU_CORES,
        )
        self.ram_mb = as_int(self.ram_mb, "ram_mb")
        check_range(self.ram_mb, "ram_mb", ge=ServerResourcesDefaults.MINIMUM_RAM_MB)

    @classmethod
    def from_dict(cls, data: object) -> ServerResources:
        return cls(
            **read_fields(
                data,
                "server_resources",
                known=("cpu_cores", "ram_mb"),
                unsupported=("db_connection_pool",),
            ),
        )


@dataclass
class Server:
    """An event-loop server exposing one or more endpoints."""

    id: str
    server_resources: ServerResources
    endpoints: list[Endpoint]
    type: SystemNodes = SystemNodes.SERVER

    def __post_init__(self) -> None:
        self.id = as_str(self.id, "server id")
        self.type = _fixed_type(self.type, SystemNodes.SERVER)
        if not self.endpoints:
            msg = f"server {self.id!r} has no endpoints"
            raise PayloadError(msg)

    @classmethod
    def from_dict(cls, data: object) -> Server:
        f = read_fields(
            data,
            "server",
            known=("id", "type", "server_resources", "endpoints"),
            required=("id", "server_resources", "endpoints"),
            unsupported=("overload", "serving"),
        )
        f["server_resources"] = ServerResources.from_dict(f["server_resources"])
        f["endpoints"] = [
            Endpoint.from_dict(e) for e in as_list(f["endpoints"], "endpoints")
        ]
        return cls(**f)


@dataclass
class LoadBalancer:
    """The single fan-out point of the topology."""

    id: str
    algorithms: LbAlgorithmsName = LbAlgorithmsName.ROUND_ROBIN
    server_covered: set[str] = field(default_factory=set)
    type: SystemNodes = SystemNodes.LOAD_BALANCER

    def __post_init__(self) -> None:
        self.id = as_str(self.id, "load balancer id")
        self.type = _fixed_type(self.type, SystemNodes.LOAD_BALANCER)
        self.algorithms = as_enum(LbAlgorithmsName, self.algorithms, "algorithms")
        self.server_covered = {
            as_str(s, "server_covered entry")
            for s in as_list(sorted(self.server_covered), "server_covered")
        }

    @classmethod
    def from_dict(cls, data: object) -> LoadBalancer:
        f = read_fields(
            data,
            "load_balancer",
            known=("id", "type", "algorithms", "server_covered"),
            required=("id",),
            unsupported=("circuit_breaker", "health"),
        )
        if "server_covered" in f:
            f["server_covered"] = set(as_list(f["server_covered"], "server_covered"))
        return cls(**f)


@dataclass
class TopologyNodes:
    """All nodes of a scenario; ids are globally unique."""

    servers: list[Server]
    client: Client
    load_balancer: LoadBalancer | None = None

    def __post_init__(self) -> None:
        if not self.servers:
            msg = "the topology needs at least one server"
            raise PayloadError(msg)
        ids = [server.id for server in self.servers] + [self.client.id]
        if self.load_balancer is not None:
            ids.append(self.load_balancer.id)
        duplicates = [i for i, count in Counter(ids).items() if count > 1]
        if duplicates:
            msg = f"The following node ids are duplicate {duplicates}"
            raise PayloadError(msg)

    @classmethod
    def from_dict(cls, data: object) -> TopologyNodes:
        f = read_fields(
            data,
            "nodes",
            known=("servers", "client", "load_balancer"),
            required=("servers", "client"),
        )
        f["servers"] = [Server.from_dict(s) for s in as_list(f["servers"], "servers")]
        f["client"] = Client.from_dict(f["client"])
        if f.get("load_balancer") is not None:
            f["load_balancer"] = LoadBalancer.from_dict(f["load_balancer"])
        return cls(**f)
