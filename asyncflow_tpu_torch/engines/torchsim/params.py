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
EV_WAIT_DB = 7  # waiting FIFO for one of the server's DB connections
EV_ABANDON = 8  # granted the core past its dequeue deadline: abandon now


class ScenarioOverrides(NamedTuple):
    """Per-scenario parameter overrides for Monte-Carlo sweeps.

    Each field matches the base plan's shape (broadcast to every scenario)
    or carries a leading scenario axis.
    """

    edge_mean: np.ndarray  # (NE,) or (S, NE)
    edge_var: np.ndarray
    edge_dropout: np.ndarray
    user_mean: np.ndarray  # scalar or (S,); (G,) or (S, G) with G generators
    req_rate: np.ndarray  # requests / user / second, shaped as user_mean


def base_overrides(plan: StaticPlan) -> ScenarioOverrides:
    """Overrides equal to the base plan (no sweep variation).  On a plan
    with several generators the workload fields are (G,), one per stream."""
    if plan.n_generators > 1:
        user_mean = np.asarray(plan.gen_user_mean, np.float32)
        req_rate = np.asarray(plan.gen_rate, np.float32)
    else:
        user_mean = np.float32(plan.user_mean)
        req_rate = np.float32(plan.req_per_user_per_sec)
    return ScenarioOverrides(
        edge_mean=np.asarray(plan.edge_mean, np.float32),
        edge_var=np.asarray(plan.edge_var, np.float32),
        edge_dropout=np.asarray(plan.edge_dropout, np.float32),
        user_mean=user_mean,
        req_rate=req_rate,
    )


def overrides_from_arrays(fields: Mapping[str, object]) -> ScenarioOverrides:
    """Overrides from a mapping of numpy arrays (for example the reference's
    ``ScenarioOverrides._asdict()``).  Only this slice's five fields are
    read: the reference's other override axes scale features (faults,
    hedging, serving) that a plan of this slice cannot carry."""
    return ScenarioOverrides(
        *[np.asarray(fields[name], np.float32) for name in ScenarioOverrides._fields],
    )


def hist_edges(n_bins: int = N_HIST_BINS) -> np.ndarray:
    """Log-spaced latency histogram bin edges (seconds), as in the reference."""
    return np.logspace(-4, 3, n_bins + 1)
