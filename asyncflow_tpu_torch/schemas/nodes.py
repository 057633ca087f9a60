"""Node schemas of the topology graph: client, server (+ resources), LB.

Same contract as the reference: node ``type`` fields keep their standard
value, resources are bounded below (>= 1 core, >= 256 MB RAM) and node ids
are unique.  Servers take the reference's overload policy (ready-queue
cap, connection cap, token-bucket rate limit, dequeue deadline) and a DB
connection pool, and the LB its circuit breaker.  Brownout degradation,
LB health gates and serving policies are refused by name.
"""

from __future__ import annotations

import math
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
    as_float,
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
    #: size of the server's DB connection pool (None = unlimited): each
    #: io_db step holds one of these FIFO connections for its duration
    db_connection_pool: int | None = ServerResourcesDefaults.DB_CONNECTION_POOL

    def __post_init__(self) -> None:
        self.cpu_cores = as_int(self.cpu_cores, "cpu_cores")
        check_range(
            self.cpu_cores, "cpu_cores", ge=ServerResourcesDefaults.MINIMUM_CPU_CORES,
        )
        self.ram_mb = as_int(self.ram_mb, "ram_mb")
        check_range(self.ram_mb, "ram_mb", ge=ServerResourcesDefaults.MINIMUM_RAM_MB)
        self.db_connection_pool = _opt_int(self.db_connection_pool, "db_connection_pool")

    @classmethod
    def from_dict(cls, data: object) -> ServerResources:
        return cls(
            **read_fields(
                data,
                "server_resources",
                known=("cpu_cores", "ram_mb", "db_connection_pool"),
            ),
        )


def _opt_int(value: object, name: str) -> int | None:
    """A positive integer, or None."""
    if value is None:
        return None
    out = as_int(value, name)
    check_range(out, name, gt=0)
    return out


def _opt_float(value: object, name: str) -> float | None:
    """A positive number, or None."""
    if value is None:
        return None
    out = as_float(value, name)
    check_range(out, name, gt=0.0)
    return out


@dataclass
class OverloadPolicy:
    """How a server protects itself under overload (the reference's
    ``OverloadPolicy`` without its brownout fields).

    ``max_ready_queue``: a request that would join a CPU ready queue already
    holding that many waiters is shed.  ``max_connections``: an arrival at a
    server with that many residents is refused.  ``rate_limit_rps`` (and
    ``rate_limit_burst``, default ``ceil(rate_limit_rps)``): a token bucket
    refuses arrivals that find no whole token; it runs before the
    connection cap.  ``queue_timeout_s``: a request that waited longer in
    the ready queue abandons when it is dequeued.  Each refusal counts as
    rejected.
    """

    max_ready_queue: int | None = None
    max_connections: int | None = None
    rate_limit_rps: float | None = None
    rate_limit_burst: int | None = None
    queue_timeout_s: float | None = None

    def __post_init__(self) -> None:
        self.max_ready_queue = _opt_int(self.max_ready_queue, "max_ready_queue")
        self.max_connections = _opt_int(self.max_connections, "max_connections")
        self.rate_limit_rps = _opt_float(self.rate_limit_rps, "rate_limit_rps")
        self.rate_limit_burst = _opt_int(self.rate_limit_burst, "rate_limit_burst")
        self.queue_timeout_s = _opt_float(self.queue_timeout_s, "queue_timeout_s")
        if self.rate_limit_burst is not None and self.rate_limit_rps is None:
            msg = "rate_limit_burst requires rate_limit_rps"
            raise PayloadError(msg)

    @property
    def effective_burst(self) -> int | None:
        """Token-bucket capacity: explicit burst, else one second's worth."""
        if self.rate_limit_rps is None:
            return None
        if self.rate_limit_burst is not None:
            return self.rate_limit_burst
        return max(1, math.ceil(self.rate_limit_rps))

    @classmethod
    def from_dict(cls, data: object) -> OverloadPolicy:
        return cls(
            **read_fields(
                data,
                "overload",
                known=(
                    "max_ready_queue",
                    "max_connections",
                    "rate_limit_rps",
                    "rate_limit_burst",
                    "queue_timeout_s",
                ),
                unsupported=(
                    "brownout_queue_threshold",
                    "brownout_cpu_factor",
                    "brownout_ram_factor",
                ),
            ),
        )


@dataclass
class CircuitBreaker:
    """Per-target circuit breaker on the load balancer (the reference's
    ``CircuitBreaker``): ``failure_threshold`` consecutive failures of one
    LB slot open it for ``cooldown_s``; then up to ``half_open_probes``
    requests probe it, and as many consecutive probe successes close it."""

    failure_threshold: int
    cooldown_s: float
    half_open_probes: int = 1

    def __post_init__(self) -> None:
        self.failure_threshold = as_int(self.failure_threshold, "failure_threshold")
        check_range(self.failure_threshold, "failure_threshold", gt=0)
        self.cooldown_s = as_float(self.cooldown_s, "cooldown_s")
        check_range(self.cooldown_s, "cooldown_s", gt=0.0)
        self.half_open_probes = as_int(self.half_open_probes, "half_open_probes")
        check_range(self.half_open_probes, "half_open_probes", gt=0)

    @classmethod
    def from_dict(cls, data: object) -> CircuitBreaker:
        return cls(
            **read_fields(
                data,
                "circuit_breaker",
                known=("failure_threshold", "cooldown_s", "half_open_probes"),
                required=("failure_threshold", "cooldown_s"),
            ),
        )


@dataclass
class Server:
    """An event-loop server exposing one or more endpoints."""

    id: str
    server_resources: ServerResources
    endpoints: list[Endpoint]
    type: SystemNodes = SystemNodes.SERVER
    overload: OverloadPolicy | None = None

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
            known=("id", "type", "server_resources", "endpoints", "overload"),
            required=("id", "server_resources", "endpoints"),
            unsupported=("serving",),
        )
        f["server_resources"] = ServerResources.from_dict(f["server_resources"])
        if f.get("overload") is not None:
            f["overload"] = OverloadPolicy.from_dict(f["overload"])
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
    circuit_breaker: CircuitBreaker | None = None

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
            known=("id", "type", "algorithms", "server_covered", "circuit_breaker"),
            required=("id",),
            unsupported=("health",),
        )
        if f.get("circuit_breaker") is not None:
            f["circuit_breaker"] = CircuitBreaker.from_dict(f["circuit_breaker"])
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
