"""Scenario schemas as plain dataclasses with explicit validation."""

from asyncflow_tpu_torch.schemas.edges import Edge
from asyncflow_tpu_torch.schemas.endpoint import Endpoint, Step
from asyncflow_tpu_torch.schemas.events import End, EventInjection, Start
from asyncflow_tpu_torch.schemas.graph import TopologyGraph
from asyncflow_tpu_torch.schemas.nodes import (
    CircuitBreaker,
    Client,
    LoadBalancer,
    OverloadPolicy,
    Server,
    ServerResources,
    TopologyNodes,
)
from asyncflow_tpu_torch.schemas.payload import SimulationPayload, load_payload
from asyncflow_tpu_torch.schemas.random_variables import RVConfig
from asyncflow_tpu_torch.schemas.resilience import (
    FailureDomain,
    FaultEvent,
    FaultTimeline,
    HazardModel,
    RetryPolicy,
)
from asyncflow_tpu_torch.schemas.settings import SimulationSettings
from asyncflow_tpu_torch.schemas.workload import RqsGenerator

__all__ = [
    "CircuitBreaker",
    "Client",
    "Edge",
    "End",
    "Endpoint",
    "EventInjection",
    "FailureDomain",
    "FaultEvent",
    "FaultTimeline",
    "HazardModel",
    "LoadBalancer",
    "OverloadPolicy",
    "RVConfig",
    "RetryPolicy",
    "RqsGenerator",
    "Server",
    "ServerResources",
    "SimulationPayload",
    "SimulationSettings",
    "Start",
    "Step",
    "TopologyGraph",
    "TopologyNodes",
    "load_payload",
]
