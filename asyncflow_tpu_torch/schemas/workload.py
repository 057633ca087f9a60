"""Workload (request-generator) schema.

Same contract as the reference ``RqsGenerator``: active users are Poisson
or Normal, the per-user request rate is Poisson, and the user re-sampling
window lies in [1, 120] seconds.  Trace replay is refused by name.
"""

from __future__ import annotations

from dataclasses import dataclass

from asyncflow_tpu_torch.config.constants import Distribution, SystemNodes, TimeDefaults
from asyncflow_tpu_torch.errors import PayloadError
from asyncflow_tpu_torch.schemas._fields import as_int, as_str, check_range, read_fields
from asyncflow_tpu_torch.schemas.random_variables import RVConfig


@dataclass
class RqsGenerator:
    """Compound stochastic arrival process: users x per-user request rate."""

    id: str
    avg_active_users: RVConfig
    avg_request_per_minute_per_user: RVConfig
    user_sampling_window: int = TimeDefaults.USER_SAMPLING_WINDOW
    type: SystemNodes = SystemNodes.GENERATOR

    def __post_init__(self) -> None:
        self.id = as_str(self.id, "generator id")
        if self.type != SystemNodes.GENERATOR:
            msg = f"The type should have a standard value: {SystemNodes.GENERATOR}"
            raise PayloadError(msg)
        self.type = SystemNodes.GENERATOR
        self.user_sampling_window = as_int(
            self.user_sampling_window, "user_sampling_window",
        )
        check_range(
            self.user_sampling_window,
            "user_sampling_window",
            ge=TimeDefaults.MIN_USER_SAMPLING_WINDOW,
            le=TimeDefaults.MAX_USER_SAMPLING_WINDOW,
        )
        if self.avg_request_per_minute_per_user.distribution != Distribution.POISSON:
            msg = "At the moment the variable avg request must be Poisson"
            raise PayloadError(msg)
        if self.avg_active_users.distribution not in {
            Distribution.POISSON,
            Distribution.NORMAL,
        }:
            msg = "At the moment the variable active user must be Poisson or Gaussian"
            raise PayloadError(msg)

    @classmethod
    def from_dict(cls, data: object) -> RqsGenerator:
        f = read_fields(
            data,
            "rqs_input",
            known=(
                "id",
                "type",
                "avg_active_users",
                "avg_request_per_minute_per_user",
                "user_sampling_window",
            ),
            required=("id", "avg_active_users", "avg_request_per_minute_per_user"),
            unsupported=("replay",),
        )
        f["avg_active_users"] = RVConfig.from_dict(
            f["avg_active_users"], "avg_active_users",
        )
        f["avg_request_per_minute_per_user"] = RVConfig.from_dict(
            f["avg_request_per_minute_per_user"], "avg_request_per_minute_per_user",
        )
        return cls(**f)
