"""Monte-Carlo sweeps."""

from asyncflow_tpu_torch.parallel.sweep import SweepReport, SweepRunner, make_overrides

__all__ = ["SweepReport", "SweepRunner", "make_overrides"]
