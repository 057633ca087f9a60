"""Wrapper of the CUDA DES kernel (``csrc/des_kernel.cu``).

For CUDA tensors it launches the kernel (built on first use) or raises;
for CPU tensors it runs the plain twin, :func:`des_reference`.  There is
no fallback from one to the other.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from asyncflow_tpu_torch.engines.torchsim import _build
from asyncflow_tpu_torch.engines.torchsim.des_reference import (
    DesOutputs,
    DesTables,
    des_reference,
)
from asyncflow_tpu_torch.errors import KernelBuildError, KernelLaunchError

_PTR_FIELDS = (
    "k0", "k1", "lam", "em", "ev", "ed",
    "seg_kind", "seg_dur", "ep_ram", "ep_cum", "edge_dist", "exit_edge",
    "exit_kind", "exit_target", "n_endpoints", "server_cores", "server_ram",
    "lb_edge_index", "lb_target", "entry_edges",
    "hist", "thr", "momf", "momi", "trunc", "n_events",
    "req_t", "req_ev", "req_srv", "req_ep", "req_seg", "req_ram", "req_ticket",
    "req_start", "req_lbslot",
    "cores_free", "ram_free", "cpu_ticket", "ram_ticket", "cpu_wait_n", "ram_wait_n",
    "lb_order", "lb_conn",
)
_INT_FIELDS = (
    "S", "P", "NS", "NE", "NEP", "NSEGP", "EL", "NW", "B", "TH", "K",
    "max_iterations", "entry_ev", "entry_target", "lb_algo", "has_ram",
)
_FLOAT_FIELDS = ("horizon", "window", "hist_lo", "hist_scale")
_TABLE_FIELDS = (
    "seg_kind", "seg_dur", "ep_ram", "ep_cum", "edge_dist", "exit_edge", "exit_kind",
    "exit_target", "n_endpoints", "server_cores", "server_ram", "lb_edge_index",
    "lb_target", "entry_edges",
)
# scratch fields: (name, dtype, per-scenario rows: "pool" | "servers" | "lb")
_SCRATCH = (
    ("req_t", torch.float32, "pool"),
    ("req_ev", torch.int32, "pool"),
    ("req_srv", torch.int32, "pool"),
    ("req_ep", torch.int32, "pool"),
    ("req_seg", torch.int32, "pool"),
    ("req_ram", torch.float32, "pool"),
    ("req_ticket", torch.int32, "pool"),
    ("req_start", torch.float32, "pool"),
    ("req_lbslot", torch.int32, "pool"),
    ("cores_free", torch.int32, "servers"),
    ("ram_free", torch.float32, "servers"),
    ("cpu_ticket", torch.int32, "servers"),
    ("ram_ticket", torch.int32, "servers"),
    ("cpu_wait_n", torch.int32, "servers"),
    ("ram_wait_n", torch.int32, "servers"),
    ("lb_order", torch.int32, "lb"),
    ("lb_conn", torch.int32, "lb"),
)


class _DesArgs(ctypes.Structure):
    """Mirror of ``struct DesArgs`` in des_kernel.cu (same field order)."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in _PTR_FIELDS]
        + [(name, ctypes.c_int32) for name in _INT_FIELDS]
        + [(name, ctypes.c_float) for name in _FLOAT_FIELDS]
    )


def _library() -> ctypes.CDLL:
    lib = _build.load("des_kernel")
    lib.des_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.des_launch.restype = ctypes.c_int
    lib.des_args_size.argtypes = []
    lib.des_args_size.restype = ctypes.c_int
    if lib.des_args_size() != ctypes.sizeof(_DesArgs):
        msg = (
            f"DesArgs layout mismatch: the library says {lib.des_args_size()} "
            f"bytes, the ctypes mirror {ctypes.sizeof(_DesArgs)}"
        )
        raise KernelBuildError(msg)
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        msg = (
            f"des_kernel: {name} must be a contiguous {dtype} tensor of shape "
            f"{shape}, got {x.dtype} {tuple(x.shape)} (contiguous={x.is_contiguous()})"
        )
        raise ValueError(msg)
    if x.device != device:
        msg = f"des_kernel: {name} is on {x.device}, expected {device}"
        raise ValueError(msg)


class DesKernel:
    """The DES kernel with its launch count."""

    name = "des_kernel"
    route = "cuda"
    source = "asyncflow_tpu_torch/csrc/des_kernel.cu"
    replaces = "asyncflow_tpu/engines/jaxsim/pallas_engine.py:1395"

    def __init__(self) -> None:
        self.launches = 0

    def __call__(
        self,
        tables: DesTables,
        k0: torch.Tensor,
        k1: torch.Tensor,
        lam: torch.Tensor,
        em: torch.Tensor,
        ev: torch.Tensor,
        ed: torch.Tensor,
    ) -> DesOutputs:
        """Run S scenarios; inputs as for :func:`des_reference`."""
        if k0.device.type == "cpu":
            return des_reference(tables, k0, k1, lam, em, ev, ed)
        if k0.device.type != "cuda":
            msg = f"des_kernel runs on cuda or cpu tensors, got {k0.device}"
            raise ValueError(msg)
        return self._launch(tables, k0, k1, lam, em, ev, ed)

    def _launch(self, t: DesTables, k0, k1, lam, em, ev, ed) -> DesOutputs:
        dev = k0.device
        s = k0.shape[0]
        _check("k0", k0, torch.int32, (s,), dev)
        _check("k1", k1, torch.int32, (s,), dev)
        _check("lam", lam, torch.float32, (s, t.n_windows), dev)
        for name, x in (("em", em), ("ev", ev), ("ed", ed)):
            _check(name, x, torch.float32, (s, t.n_edges), dev)
        for name in _TABLE_FIELDS:
            tab = getattr(t, name)
            if tab.device != dev or not tab.is_contiguous():
                msg = f"des_kernel: table {name} must be contiguous on {dev}"
                raise ValueError(msg)
        if s == 0 or s >= 2**31 // max(t.pool, 1):
            msg = f"des_kernel: batch of {s} scenarios is out of range"
            raise ValueError(msg)

        out = DesOutputs(
            hist=torch.empty((s, t.n_hist_bins), dtype=torch.int32, device=dev),
            thr=torch.empty((s, t.n_thr), dtype=torch.int32, device=dev),
            momf=torch.empty((s, 6), dtype=torch.float32, device=dev),
            momi=torch.empty((s, 5), dtype=torch.int32, device=dev),
            trunc=torch.empty((s,), dtype=torch.int32, device=dev),
            n_events=torch.empty((s,), dtype=torch.int32, device=dev),
        )
        rows = {"pool": t.pool, "servers": t.n_servers, "lb": max(t.n_lb, 1)}
        scratch = {
            name: torch.empty((rows[kind], s), dtype=dtype, device=dev)
            for name, dtype, kind in _SCRATCH
        }
        tensors = {
            "k0": k0, "k1": k1, "lam": lam, "em": em, "ev": ev, "ed": ed,
            **{name: getattr(t, name) for name in _TABLE_FIELDS},
            **out._asdict(),
            **scratch,
        }
        args = _DesArgs(
            **{name: tensors[name].data_ptr() for name in _PTR_FIELDS},
            S=s,
            P=t.pool,
            NS=t.n_servers,
            NE=t.n_edges,
            NEP=t.n_ep,
            NSEGP=t.n_segp,
            EL=t.n_lb,
            NW=t.n_windows,
            B=t.n_hist_bins,
            TH=t.n_thr,
            K=int(t.entry_edges.numel()),
            max_iterations=t.max_iterations,
            entry_ev=t.entry_ev,
            entry_target=t.entry_target,
            lb_algo=t.lb_algo,
            has_ram=t.has_ram,
            horizon=t.horizon,
            window=t.window,
            hist_lo=t.hist_lo,
            hist_scale=t.hist_scale,
        )
        lib = _library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.des_launch(ctypes.byref(args), ctypes.c_void_p(stream))
        if rc != 0:
            msg = f"des_kernel launch failed: cudaGetLastError() = {rc}"
            raise KernelLaunchError(msg)
        self.launches += 1
        return out
