"""Monte-Carlo sweeps."""

from asyncflow_tpu_torch.parallel.sweep import SweepReport, SweepRunner

__all__ = ["SweepReport", "SweepRunner"]
