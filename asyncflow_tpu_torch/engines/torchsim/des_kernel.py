"""Wrapper of the CUDA DES kernel (``csrc/des_kernel.cu``).

For CUDA tensors it launches the kernel (built on first use) or raises;
for CPU tensors it runs the plain twin, :func:`des_reference`.  There is
no fallback from one to the other.  ``launches`` counts kernel launches.
The source is built into two libraries: ``des_kernel`` without the
workload group (cache, LLM, DB pools, several generators) and
``des_kernel_workload`` with it; a launch loads the one its plan needs.
"""

from __future__ import annotations

import ctypes

import torch

from asyncflow_tpu_torch.engines.torchsim import _build
from asyncflow_tpu_torch.engines.torchsim.des_reference import (
    WORK_KINDS,
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
    "spike_times", "spike_vals", "tl_times", "tl_down", "tl_slot",
    "queue_cap", "conn_cap", "rate_limit", "rate_burst", "queue_timeout",
    "seg_hit_prob", "seg_miss_dur", "seg_llm_tokens", "seg_llm_tpt", "seg_llm_cost",
    "db_pool", "gen_entry_edges", "gen_entry_len", "gen_entry_ev", "gen_entry_target",
    "gen_window", "gen_lam_off", "gen_nw",
    "hist", "thr", "momf", "momi", "trunc", "n_events", "work",
    "pool_scratch",
)
_INT_FIELDS = (
    "S", "P", "NS", "NE", "NEP", "NSEGP", "EL", "NW", "B", "TH", "K",
    "max_iterations", "entry_ev", "entry_target", "lb_algo", "has_ram",
    "NB", "NTL", "has_shed", "has_conn", "has_rl", "has_timeout",
    "cb_threshold", "cb_probes", "G", "L", "has_cache", "has_llm", "has_db",
)
_FLOAT_FIELDS = ("horizon", "window", "hist_lo", "hist_scale", "cb_cooldown")
_TABLE_FIELDS = (
    "seg_kind", "seg_dur", "ep_ram", "ep_cum", "edge_dist", "exit_edge", "exit_kind",
    "exit_target", "n_endpoints", "server_cores", "server_ram", "lb_edge_index",
    "lb_target", "entry_edges",
    # optional: None when the plan does not model the feature
    "spike_times", "spike_vals", "tl_times", "tl_down", "tl_slot",
    "queue_cap", "conn_cap", "rate_limit", "rate_burst", "queue_timeout",
    "seg_hit_prob", "seg_miss_dur", "seg_llm_tokens", "seg_llm_tpt", "seg_llm_cost",
    "db_pool", "gen_entry_edges", "gen_entry_len", "gen_entry_ev", "gen_entry_target",
    "gen_window", "gen_lam_off", "gen_nw",
)
#: library names (engines/torchsim/_build.py) by whether the plan needs the
#: workload group
_LIBRARY = {False: "des_kernel", True: "des_kernel_workload"}


class _DesArgs(ctypes.Structure):
    """Mirror of ``struct DesArgs`` in des_kernel.cu (same field order)."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in _PTR_FIELDS]
        + [(name, ctypes.c_int32) for name in _INT_FIELDS]
        + [(name, ctypes.c_float) for name in _FLOAT_FIELDS]
    )


def needs_workload(t: DesTables) -> bool:
    """Does the plan need the instances with the workload group?"""
    return (
        t.seg_hit_prob is not None
        or t.seg_llm_tokens is not None
        or t.db_pool is not None
        or t.n_gen > 1
    )


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of des_kernel.cu on ``lib``."""
    for fn, args in (
        ("des_launch", [ctypes.c_void_p, ctypes.c_void_p]),
        ("des_layout", [ctypes.c_void_p, ctypes.c_void_p]),
        ("des_occupancy", [ctypes.c_void_p, ctypes.c_void_p]),
        ("des_args_size", []),
        ("des_workload", []),
    ):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _library(workload: bool) -> ctypes.CDLL:
    lib = bind(_build.load(_LIBRARY[workload]))
    if lib.des_workload() != int(workload):
        msg = f"{_LIBRARY[workload]}: the library was built with the other instances"
        raise KernelBuildError(msg)
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
        lib = _library(needs_workload(t))
        args, out, _keep = pack_args(t, k0, k1, lam, em, ev, ed, lib=lib)
        stream = torch.cuda.current_stream(k0.device).cuda_stream
        rc = lib.des_launch(ctypes.byref(args), ctypes.c_void_p(stream))
        if rc != 0:
            msg = (
                f"des_kernel launch failed: code {rc} (a cudaError_t, or a refusal "
                "of des_launch)"
            )
            raise KernelLaunchError(msg)
        self.launches += 1
        return out


#: DesLayout.placement by value: where a scenario's request pool lives
PLACEMENTS = ("scan_shared", "global")
_LAYOUT_KEYS = (
    "placement", "warps_per_block", "shared_bytes", "shared_fields", "warp_words",
    "global_words", "instance",
)
#: DesLayout.instance bits: the feature groups the launch's instance compiles in
_INSTANCE_BITS = {"events": 1, "controls": 2, "workload": 4}


def query_layout(lib: ctypes.CDLL, args: _DesArgs) -> dict:
    """The layout a launch of ``args`` takes (des_layout): the pool's
    placement, scenarios a block, shared bytes a block, pool fields in
    shared memory, shared words and global scratch words a scenario, and
    the feature groups of the instance it runs."""
    out = (ctypes.c_int32 * len(_LAYOUT_KEYS))()
    rc = lib.des_layout(ctypes.byref(args), out)
    if rc != 0:
        msg = f"des_kernel: one scenario's state does not fit a block (code {rc})"
        raise KernelLaunchError(msg)
    layout = dict(zip(_LAYOUT_KEYS, out))
    layout["placement"] = PLACEMENTS[layout["placement"]]
    layout["instance"] = {k: bool(layout["instance"] & b) for k, b in _INSTANCE_BITS.items()}
    return layout


def launch_layout(t: DesTables) -> dict:
    """The layout and occupancy of the plan's launches on the card: the
    keys of :func:`query_layout`, and the blocks and warps an SM holds
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = _library(needs_workload(t))
    args = _DesArgs(**_geometry(t, 1))
    layout = query_layout(lib, args)
    blocks = ctypes.c_int32(0)
    rc = lib.des_occupancy(ctypes.byref(args), ctypes.byref(blocks))
    if rc != 0:
        msg = f"des_kernel occupancy query failed: code {rc}"
        raise KernelLaunchError(msg)
    return {
        **layout,
        "blocks_per_sm": blocks.value,
        "warps_per_sm": blocks.value * layout["warps_per_block"],
    }


def _geometry(t: DesTables, s: int) -> dict:
    """The int and float fields of DesArgs for ``s`` scenarios of plan ``t``."""
    return {
        "S": s,
        "P": t.pool,
        "NS": t.n_servers,
        "NE": t.n_edges,
        "NEP": t.n_ep,
        "NSEGP": t.n_segp,
        "EL": t.n_lb,
        "NW": t.n_windows,
        "B": t.n_hist_bins,
        "TH": t.n_thr,
        "K": int(t.entry_edges.numel()),
        "max_iterations": t.max_iterations,
        "entry_ev": t.entry_ev,
        "entry_target": t.entry_target,
        "lb_algo": t.lb_algo,
        "has_ram": t.has_ram,
        "NB": t.n_spikes,
        "NTL": t.n_timeline,
        "has_shed": int(t.queue_cap is not None),
        "has_conn": int(t.conn_cap is not None),
        "has_rl": int(t.rate_limit is not None),
        "has_timeout": int(t.queue_timeout is not None),
        "cb_threshold": t.breaker_threshold,
        "cb_probes": t.breaker_probes,
        "G": t.n_gen,
        "L": t.max_chain,
        "has_cache": int(t.seg_hit_prob is not None),
        "has_llm": int(t.seg_llm_tokens is not None),
        "has_db": int(t.db_pool is not None),
        "horizon": t.horizon,
        "window": t.window,
        "hist_lo": t.hist_lo,
        "hist_scale": t.hist_scale,
        "cb_cooldown": t.breaker_cooldown,
    }


def pack_args(
    t: DesTables, k0, k1, lam, em, ev, ed, *, lib: ctypes.CDLL,
) -> tuple[_DesArgs, DesOutputs, dict]:
    """Check the inputs and allocate the outputs and the global scratch of
    one launch (as much as ``lib``'s layout leaves out of shared memory):
    ``(args, outputs, tensors)``, where ``args`` points into ``tensors``,
    which must stay alive until the kernel has run."""
    dev = k0.device
    s = k0.shape[0]
    _check("k0", k0, torch.int32, (s,), dev)
    _check("k1", k1, torch.int32, (s,), dev)
    _check("lam", lam, torch.float32, (s, t.n_windows), dev)
    for name, x in (("em", em), ("ev", ev), ("ed", ed)):
        _check(name, x, torch.float32, (s, t.n_edges), dev)
    for name in _TABLE_FIELDS:
        tab = getattr(t, name)
        if tab is not None and (tab.device != dev or not tab.is_contiguous()):
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
        work=torch.empty((s, len(WORK_KINDS)), dtype=torch.int32, device=dev),
    )
    args = _DesArgs(**_geometry(t, s))
    global_words = query_layout(lib, args)["global_words"]
    scratch = torch.empty((s, global_words), dtype=torch.int32, device=dev)
    tensors = {
        "k0": k0, "k1": k1, "lam": lam, "em": em, "ev": ev, "ed": ed,
        **{name: getattr(t, name) for name in _TABLE_FIELDS},
        **out._asdict(),
        "pool_scratch": scratch,
    }
    # a feature the plan does not model passes null pointers
    for name in _PTR_FIELDS:
        if tensors.get(name) is not None:
            setattr(args, name, tensors[name].data_ptr())
    return args, out, tensors
