"""Enums of the scenario file format that the port's schemas and compiler use.

Only the values are shared with the reference package: they are the public
file format.  This module is the port's own copy of the subset it needs.
"""

from __future__ import annotations

from enum import StrEnum


class Distribution(StrEnum):
    """Sampling distributions accepted by :class:`RVConfig`."""

    POISSON = "poisson"
    NORMAL = "normal"
    LOG_NORMAL = "log_normal"
    EXPONENTIAL = "exponential"
    UNIFORM = "uniform"


class EndpointStepIO(StrEnum):
    """I/O-bound step kinds (the event loop yields, no core is held)."""

    TASK_SPAWN = "io_task_spawn"
    LLM = "io_llm"
    WAIT = "io_wait"
    DB = "io_db"
    CACHE = "io_cache"


class EndpointStepCPU(StrEnum):
    """CPU-bound step kinds (a core is held)."""

    INITIAL_PARSING = "initial_parsing"
    CPU_BOUND_OPERATION = "cpu_bound_operation"


class EndpointStepRAM(StrEnum):
    """Memory reservation steps (working set held for the whole request)."""

    RAM = "ram"


class StepOperation(StrEnum):
    """Quantity keys allowed inside a step definition."""

    CPU_TIME = "cpu_time"
    IO_WAITING_TIME = "io_waiting_time"
    NECESSARY_RAM = "necessary_ram"


class SystemNodes(StrEnum):
    """Node kinds of the topology graph."""

    GENERATOR = "generator"
    SERVER = "server"
    CLIENT = "client"
    LOAD_BALANCER = "load_balancer"


class SystemEdges(StrEnum):
    """Edge kinds connecting system nodes."""

    NETWORK_CONNECTION = "network_connection"


class LbAlgorithmsName(StrEnum):
    """Routing policies of the load balancer."""

    ROUND_ROBIN = "round_robin"
    LEAST_CONNECTIONS = "least_connection"


class EventDescription(StrEnum):
    """Kinds of events that can be injected in a simulation window."""

    SERVER_UP = "server_up"
    SERVER_DOWN = "server_down"
    NETWORK_SPIKE_START = "network_spike_start"
    NETWORK_SPIKE_END = "network_spike_end"


class FaultKind(StrEnum):
    """Fault-window kinds of the resilience schemas: ``server_outage``
    hard-refuses arrivals at the server (the LB learns of it only through
    its breaker), ``edge_degrade`` multiplies an edge's latency and/or
    boosts its dropout inside the window, ``edge_partition`` drops every
    send on the edge."""

    SERVER_OUTAGE = "server_outage"
    EDGE_DEGRADE = "edge_degrade"
    EDGE_PARTITION = "edge_partition"


class RetryDefaults:
    """Defaults and bounds of the client retry policy."""

    MAX_ATTEMPTS = 3
    #: attempts a logical request may use at most: bounds the attempts
    #: histogram and the retry amplification of the capacity estimate
    MAX_ATTEMPTS_CAP = 16


class SampledMetricName(StrEnum):
    """Fixed-cadence time-series metrics (accepted, not collected by sweeps)."""

    READY_QUEUE_LEN = "ready_queue_len"
    EVENT_LOOP_IO_SLEEP = "event_loop_io_sleep"
    RAM_IN_USE = "ram_in_use"
    EDGE_CONCURRENT_CONNECTION = "edge_concurrent_connection"


class EventMetricName(StrEnum):
    """Per-request metrics (accepted, not collected by sweeps)."""

    RQS_CLOCK = "rqs_clock"
    LLM_COST = "llm_cost"


class TimeDefaults:
    """Time defaults and validation bounds (seconds)."""

    USER_SAMPLING_WINDOW = 60
    SIMULATION_TIME = 3_600
    MIN_SIMULATION_TIME = 5
    MIN_USER_SAMPLING_WINDOW = 1
    MAX_USER_SAMPLING_WINDOW = 120


class SamplePeriods:
    """Range of the sampling cadence of time-series metrics."""

    STANDARD_TIME = 0.01
    MINIMUM_TIME = 0.001
    MAXIMUM_TIME = 0.1


class ServerResourcesDefaults:
    """Defaults and minima of per-server resources."""

    CPU_CORES = 1
    MINIMUM_CPU_CORES = 1
    RAM_MB = 1024
    MINIMUM_RAM_MB = 256
    DB_CONNECTION_POOL = None


class NetworkParameters:
    """Defaults and bounds of network edges."""

    MIN_DROPOUT_RATE = 0.0
    DROPOUT_RATE = 0.01
    MAX_DROPOUT_RATE = 1.0
