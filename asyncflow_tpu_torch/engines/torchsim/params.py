"""Engine constants and per-scenario overrides (the slice's subset of the
reference's ``engines/jaxsim/params.py``)."""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np

from asyncflow_tpu_torch.compiler.plan import StaticPlan
from asyncflow_tpu_torch.engines.torchsim.sampling import N_HIST_BINS

INF = 1e30  # "never" for event times; finite, as in the reference
NO_TICKET = 2**30

# request-slot event codes (the reference's numbering)
EV_IDLE = 0
EV_ARRIVE_LB = 1
EV_ARRIVE_SRV = 2
EV_SEG_END = 3
EV_RESUME = 4  # RAM granted; start the endpoint's segments at time t
EV_WAIT_CPU = 5
EV_WAIT_RAM = 6


class ScenarioOverrides(NamedTuple):
    """Per-scenario parameter overrides for Monte-Carlo sweeps.

    Each field matches the base plan's shape (broadcast to every scenario)
    or carries a leading scenario axis.
    """

    edge_mean: np.ndarray  # (NE,) or (S, NE)
    edge_var: np.ndarray
    edge_dropout: np.ndarray
    user_mean: np.ndarray  # scalar or (S,)
    req_rate: np.ndarray  # requests / user / second, scalar or (S,)


def base_overrides(plan: StaticPlan) -> ScenarioOverrides:
    """Overrides equal to the base plan (no sweep variation)."""
    return ScenarioOverrides(
        edge_mean=np.asarray(plan.edge_mean, np.float32),
        edge_var=np.asarray(plan.edge_var, np.float32),
        edge_dropout=np.asarray(plan.edge_dropout, np.float32),
        user_mean=np.float32(plan.user_mean),
        req_rate=np.float32(plan.req_per_user_per_sec),
    )


def overrides_from_arrays(fields: Mapping[str, object]) -> ScenarioOverrides:
    """Overrides from a mapping of numpy arrays (for example the reference's
    ``ScenarioOverrides._asdict()``).  Only this slice's five fields are
    read: the reference's other override axes scale features (faults,
    hedging, serving) that a plan of this slice cannot carry."""
    return ScenarioOverrides(
        *[np.asarray(fields[name], np.float32) for name in ScenarioOverrides._fields],
    )


def hist_edges() -> np.ndarray:
    """Log-spaced latency histogram bin edges (seconds), as in the reference."""
    return np.logspace(-4, 3, N_HIST_BINS + 1)
