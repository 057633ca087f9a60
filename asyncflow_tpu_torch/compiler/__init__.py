"""Payload -> StaticPlan lowering."""

from asyncflow_tpu_torch.compiler.plan import (
    KERNEL_FIELDS,
    StaticPlan,
    compile_payload,
    plan_from_arrays,
)

__all__ = ["KERNEL_FIELDS", "StaticPlan", "compile_payload", "plan_from_arrays"]
