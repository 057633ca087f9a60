"""Scenario schemas as plain dataclasses with explicit validation."""

from asyncflow_tpu_torch.schemas.edges import Edge
from asyncflow_tpu_torch.schemas.endpoint import Endpoint, Step
from asyncflow_tpu_torch.schemas.graph import TopologyGraph
from asyncflow_tpu_torch.schemas.nodes import (
    Client,
    LoadBalancer,
    Server,
    ServerResources,
    TopologyNodes,
)
from asyncflow_tpu_torch.schemas.payload import SimulationPayload, load_payload
from asyncflow_tpu_torch.schemas.random_variables import RVConfig
from asyncflow_tpu_torch.schemas.settings import SimulationSettings
from asyncflow_tpu_torch.schemas.workload import RqsGenerator

__all__ = [
    "Client",
    "Edge",
    "Endpoint",
    "LoadBalancer",
    "RVConfig",
    "RqsGenerator",
    "Server",
    "ServerResources",
    "SimulationPayload",
    "SimulationSettings",
    "Step",
    "TopologyGraph",
    "TopologyNodes",
    "load_payload",
]
