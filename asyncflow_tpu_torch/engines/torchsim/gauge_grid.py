"""The fast path's gauge grid: each gauge site's intervals scattered onto the
sample ticks (the reference's ``FastEngine._gauge_intervals``).

An interval ``[t0, t1)`` of a lane with ``on`` adds ``+amount`` at the
bucket of ``t0`` and ``-amount`` at the bucket of ``t1``
(``sampling.sample_bucket``) into its gauge's column of the (S, rows,
n_gauges) float32 grid; the cumulative sum over the rows then gives each
tick's gauge value.  On a CUDA tensor :class:`GaugeGrid` launches
``csrc/gauge_grid.cu``; on a CPU tensor it runs the plain version,
:func:`gauge_add_plain`, torch's ``scatter_add_`` on the two buckets.
"""

from __future__ import annotations

import ctypes

import torch

from asyncflow_tpu_torch.engines.torchsim import _build
from asyncflow_tpu_torch.engines.torchsim.sampling import bucket_scale, sample_bucket
from asyncflow_tpu_torch.errors import KernelBuildError, KernelLaunchError


def gauge_add_plain(grid: torch.Tensor, col: int, t0: torch.Tensor, t1: torch.Tensor,
                    on: torch.Tensor, amount, period: float) -> None:
    """Add one site's intervals into column ``col`` of ``grid`` (S, rows, G)
    in place: ``t0``, ``t1`` (S, n) float32, ``on`` (S, n) bool, ``amount``
    a float or (S, n) float32."""
    n_samples = grid.shape[1] - 2
    val = torch.where(on, amount, 0.0).to(torch.float32)
    column = grid[:, :, col]
    column.scatter_add_(1, sample_bucket(t0, period, n_samples), val)
    column.scatter_add_(1, sample_bucket(t1, period, n_samples), -val)


class PlainGaugeGrid:
    """The plain version with the wrapper's interface, on any device."""

    launches = 0

    def add(self, grid, col, t0, t1, on, amount, period) -> None:
        gauge_add_plain(grid, col, t0, t1, on, amount, period)


class _GaugeGridArgs(ctypes.Structure):
    """Mirror of ``struct GaugeGridArgs`` in gauge_grid.cu (same order)."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in ("t0", "t1", "on", "amount", "grid")]
        + [(name, ctypes.c_int64) for name in ("S", "n")]
        + [(name, ctypes.c_int32) for name in ("rows", "G", "col")]
        + [(name, ctypes.c_float) for name in ("scale", "amount_scalar")]
    )


def _library() -> ctypes.CDLL:
    lib = _build.load("gauge_grid")
    lib.gauge_grid_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.gauge_grid_launch.restype = ctypes.c_int
    lib.gauge_grid_args_size.restype = ctypes.c_int
    lib.gauge_grid_shared_rows.restype = ctypes.c_int
    if lib.gauge_grid_args_size() != ctypes.sizeof(_GaugeGridArgs):
        msg = "GaugeGridArgs layout mismatch between gauge_grid.cu and its ctypes mirror"
        raise KernelBuildError(msg)
    return lib


class GaugeGrid:
    """The gauge grid's scatter, with the launch count (``launches``) and
    each form's (``form_launches``: the column in shared memory, or global
    atomics for grids of more rows than ``gauge_grid_shared_rows``)."""

    name = "gauge_grid"
    route = "cuda"
    source = "asyncflow_tpu_torch/csrc/gauge_grid.cu"
    replaces = ("asyncflow_tpu/engines/jaxsim/fastpath.py:1138-1144 (_gauge_intervals: "
                "XLA's scatter-add of each interval's endpoints; no Pallas kernel)")

    def __init__(self) -> None:
        self.launches = 0
        self.form_launches = {"shared": 0, "global": 0}

    def add(self, grid: torch.Tensor, col: int, t0: torch.Tensor, t1: torch.Tensor,
            on: torch.Tensor, amount, period: float) -> None:
        """Add one gauge site's intervals into column ``col`` of ``grid``
        (S, rows, G) float32, in place (:func:`gauge_add_plain`)."""
        if grid.device.type == "cpu":
            gauge_add_plain(grid, col, t0, t1, on, amount, period)
            return
        dev = grid.device
        if dev.type != "cuda":
            msg = f"gauge_grid runs on cuda or cpu tensors, got {dev}"
            raise ValueError(msg)
        s, rows, g = grid.shape
        n = t0.shape[1]
        if grid.dtype != torch.float32 or not grid.is_contiguous():
            msg = "gauge_grid: the grid must be a contiguous float32 tensor"
            raise ValueError(msg)
        t0 = _lanes(t0, torch.float32, (s, n), dev, "t0")
        t1 = _lanes(t1, torch.float32, (s, n), dev, "t1")
        on = _lanes(on, torch.bool, (s, n), dev, "on")
        lane_amount = None
        if isinstance(amount, torch.Tensor) and amount.ndim > 0:
            lane_amount = _lanes(amount, torch.float32, (s, n), dev, "amount")
            scalar = 0.0
        else:
            scalar = float(amount)
        if s == 0 or n == 0:
            return
        lib = _library()
        args = _GaugeGridArgs(
            t0=t0.data_ptr(), t1=t1.data_ptr(), on=on.data_ptr(),
            amount=None if lane_amount is None else lane_amount.data_ptr(),
            grid=grid.data_ptr(), S=s, n=n, rows=rows, G=g, col=col,
            scale=bucket_scale(period), amount_scalar=scalar,
        )
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gauge_grid_launch(ctypes.byref(args), ctypes.c_void_p(stream))
        if rc != 0:
            msg = f"gauge_grid launch failed: code {rc}"
            raise KernelLaunchError(msg)
        self.launches += 1
        self.form_launches["shared" if rows <= lib.gauge_grid_shared_rows() else "global"] += 1


def _lanes(x: torch.Tensor, dtype: torch.dtype, shape: tuple, dev, name: str) -> torch.Tensor:
    """``x`` as a contiguous (S, n) tensor of ``dtype`` on ``dev`` (a copy
    where it is a strided view)."""
    if tuple(x.shape) != shape or x.device != dev:
        msg = (f"gauge_grid: {name} must have shape {shape} on {dev}, got "
               f"{tuple(x.shape)} on {x.device}")
        raise ValueError(msg)
    return x.to(dtype).contiguous()
