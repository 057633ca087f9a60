"""Distribution ids and latency-histogram constants shared with the kernel
(the slice's subset of the reference's ``engines/jaxsim/sampling.py``)."""

from __future__ import annotations

import numpy as np

TINY = 1e-15

# distribution ids (compiler order)
D_UNIFORM, D_POISSON, D_EXPONENTIAL, D_NORMAL, D_LOGNORMAL = range(5)

HIST_LO_S = 1e-4
HIST_HI_S = 1e3
#: bins of the shared latency histogram (the reference sweep's 1024)
N_HIST_BINS = 1024


def hist_constants(n_bins: int = N_HIST_BINS) -> tuple[float, float]:
    """(log-lo, bins-per-log) of a latency histogram of ``n_bins`` bins."""
    lo = float(np.log(HIST_LO_S))
    scale = float(n_bins / (np.log(HIST_HI_S) - np.log(HIST_LO_S)))
    return lo, scale


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float.  Torch applies a Python
    scalar to a float32 tensor in float32, so passing values that float32
    holds exactly keeps the arithmetic identical to the kernel's."""
    return float(np.float32(x))


def latency_bin(latency, lo: float, scale: float, n_bins: int):
    """Log-histogram bin of float32 latencies (torch tensor): truncation of
    ``(log(max(lat, 1e-6)) - lo) * scale`` toward zero, then a clip."""
    import torch

    x = (torch.log(torch.clamp_min(latency, f32(1e-6))) - f32(lo)) * f32(scale)
    return torch.clamp(x.to(torch.int32), 0, n_bins - 1)


def bucket_scale(period: float) -> float:
    """The float32 reciprocal of a sample period, as XLA folds a division by
    the constant into a multiply: ``x / period`` is ``x * (1 / period)`` with
    the reciprocal rounded to float32 from float32 operands."""
    return float(np.float32(1.0) / np.float32(period))


def sample_bucket(t, period: float, n_samples: int):
    """Sample-tick bucket of float32 times (torch tensor): a delta at ``t``
    affects the samples at ticks >= t, ``ceil(t / period)`` clipped to
    ``[0, n_samples + 1]`` (int64).  The quotient is XLA's (``bucket_scale``);
    the clip comes before the integer conversion, so "never" (``INF``) lands
    in the last row."""
    import torch

    b = torch.ceil(t * bucket_scale(period))
    return torch.clamp(b, 0.0, float(n_samples + 1)).to(torch.int64)
