"""Host side of the DES kernel: the counterpart of the reference's
``PallasEngine`` (``asyncflow_tpu/engines/jaxsim/pallas_engine.py``:
``__init__``, ``_lam_table``, ``run_batch``, ``_prepare``).

:class:`KernelEngine` refuses plans outside this slice before any launch,
builds the plan tables on the device, draws each scenario's arrival-rate
table (one block per generator), and runs the kernel (or, for a CPU
device, its plain twin).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from asyncflow_tpu_torch.compiler.plan import (
    SEG_CACHE,
    SEG_CPU,
    SEG_DB,
    SEG_END,
    SEG_IO,
    SEG_LLM,
    TARGET_LB,
    TARGET_SERVER,
    UNSUPPORTED_SEGMENTS,
    StaticPlan,
)
from asyncflow_tpu_torch.device import resolve_device
from asyncflow_tpu_torch.engines.torchsim.des_kernel import DesKernel
from asyncflow_tpu_torch.engines.torchsim.des_reference import make_des_tables
from asyncflow_tpu_torch.engines.torchsim.keys import (
    MASK32,
    fold_in,
    keys_as_int32,
    threefry2x32,
)
from asyncflow_tpu_torch.engines.torchsim.params import ScenarioOverrides, base_overrides
from asyncflow_tpu_torch.engines.torchsim.sampling import TINY, f32
from asyncflow_tpu_torch.errors import PayloadError, UnsupportedFeatureError

#: fold-in tag of the arrival-rate stream of generator 0; generator g's is
#: LAM_STREAM + g (pallas_engine.py:1594)
LAM_STREAM = 0x77AB


class KernelState(NamedTuple):
    """Sweep-mode outputs (the reference's ``PallasState`` fields, plus the
    number of events each scenario simulated)."""

    hist: np.ndarray
    lat_count: np.ndarray
    lat_sum: np.ndarray
    lat_sumsq: np.ndarray
    lat_min: np.ndarray
    lat_max: np.ndarray
    thr: np.ndarray
    clock: np.ndarray
    clock_n: np.ndarray
    n_generated: np.ndarray
    n_dropped: np.ndarray
    n_overflow: np.ndarray
    truncated: np.ndarray
    llm_sum: np.ndarray
    llm_sumsq: np.ndarray
    n_rejected: np.ndarray
    n_events: np.ndarray


#: the resilience features the DES kernel does not model, as the
#: reference's Pallas kernel does not (its fences ``resilience.pallas`` and
#: ``hazard.pallas``): fault windows, sampled hazards and client retries
#: run on the scan fast path only
KERNEL_REFUSES = (
    ("faults", lambda plan: plan.has_faults),
    ("hazards", lambda plan: plan.has_hazards),
    ("retry", lambda plan: plan.has_retry),
)


def check_slice(plan: StaticPlan) -> None:
    """Raise :class:`UnsupportedFeatureError` for a plan this slice cannot run."""
    if plan.unsupported:
        raise UnsupportedFeatureError(plan.unsupported[0], "plan")
    for feature, test in KERNEL_REFUSES:
        if test(plan):
            raise UnsupportedFeatureError(feature, "DES kernel; the scan fast path runs it")
    for kind in np.unique(np.asarray(plan.seg_kind)).tolist():
        if kind in UNSUPPORTED_SEGMENTS:
            raise UnsupportedFeatureError(UNSUPPORTED_SEGMENTS[kind], "plan segments")
        if kind not in (SEG_END, SEG_CPU, SEG_IO, SEG_DB, SEG_CACHE, SEG_LLM):
            msg = f"unknown segment kind {kind}"
            raise PayloadError(msg)
    kinds = [plan.entry_target_kind, *np.asarray(plan.gen_entry_target_kind).tolist()]
    if any(kind not in (TARGET_LB, TARGET_SERVER) for kind in kinds):
        msg = "every entry chain must end at the load balancer or a server"
        raise PayloadError(msg)


def _keys_tensor(keys, device: torch.device) -> torch.Tensor:
    """(S, 2) int64 key words in [0, 2**32) on ``device``."""
    if isinstance(keys, torch.Tensor):
        return (keys.to(device=device, dtype=torch.int64)) & MASK32
    arr = np.asarray(keys).astype(np.uint32).astype(np.int64)
    return torch.as_tensor(arr, device=device)


def _uniform53(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """float64 uniform in [0, 1) from two 32-bit words."""
    return ((b0 << 21) | (b1 >> 11)).to(torch.float64) * (2.0**-53)


def _poisson_inverse(mean: torch.Tensor, u: torch.Tensor, kmax: float) -> torch.Tensor:
    """Smallest k with P(X <= k) >= u for X ~ Poisson(mean), by bisection
    on the CDF Q(k + 1, mean) (float64).  ``kmax`` bounds the search: it
    sits 12 standard deviations above the largest mean."""
    lo = torch.zeros_like(u, dtype=torch.int64)
    hi = torch.full_like(lo, int(kmax))
    for _ in range(max(1, math.ceil(math.log2(kmax + 1)) + 1)):
        mid = (lo + hi) // 2
        ge = torch.special.gammaincc((mid + 1).to(torch.float64), mean) >= u
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid + 1)
    return lo


def lam_table(
    keys: torch.Tensor,
    user_mean,
    req_rate,
    *,
    n_windows: int,
    user_var: float,
    stream: int = 0,
) -> torch.Tensor:
    """(S, NW) float32 arrival rates of generator ``stream``: users per
    window x requests per user.

    The users of window ``w`` are drawn from the threefry stream
    ``fold_in(key, 0x77AB + stream)`` at counter ``(w, 0)`` (and ``(w, 1)``):
    Poisson(user_mean) by CDF inversion when ``user_var < 0``, else
    ``max(0, user_mean + user_var * z)`` with a Box-Muller normal ``z``.  A
    scenario's table is a pure function of its key, so chunking a sweep
    does not change it.  The distribution is the reference's; the numbers
    are not (its ``jax.random.poisson`` / ``normal`` have no port).
    """
    dev = keys.device
    s = keys.shape[0]
    kd = fold_in(keys, LAM_STREAM + stream)
    k0, k1 = kd[:, 0:1], kd[:, 1:2]
    w = torch.arange(n_windows, dtype=torch.int64, device=dev)[None, :]
    um = _float_tensor(user_mean, dev).expand(s)[:, None]
    rr = _float_tensor(req_rate, dev).expand(s)[:, None]
    b0, b1 = threefry2x32(k0, k1, w, torch.zeros_like(w))
    u1 = _uniform53(b0, b1)
    if user_var < 0:
        mean = torch.clamp_min(um, f32(TINY)).to(torch.float64)
        top = float(np.max(np.asarray(user_mean, np.float64)))
        kmax = math.ceil(top + 12.0 * math.sqrt(max(top, 1.0)) + 20.0)
        users = _poisson_inverse(mean.expand(s, n_windows), u1, kmax).to(torch.float32)
    else:
        c0, c1 = threefry2x32(k0, k1, w, torch.ones_like(w))
        u2 = _uniform53(c0, c1)
        z = torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos((2.0 * math.pi) * u2)
        users = torch.clamp_min(um + f32(user_var) * z.to(torch.float32), 0.0)
    return (users * rr).contiguous()


def _float_tensor(x, device: torch.device) -> torch.Tensor:
    """A contiguous float32 tensor on ``device`` (numpy input is copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _edge_table(field, s: int, ne: int, device: torch.device) -> torch.Tensor:
    arr = _float_tensor(field, device)
    if arr.ndim == 1:
        arr = arr[None, :].expand(s, ne)
    if tuple(arr.shape) != (s, ne):
        msg = f"edge override of shape {tuple(arr.shape)} does not match ({s}, {ne})"
        raise ValueError(msg)
    return arr.contiguous()


class KernelEngine:
    """Batched DES kernel for one :class:`StaticPlan`: the counterpart of the
    reference's ``PallasEngine`` in sweep mode."""

    def __init__(self, plan: StaticPlan, *, device: torch.device | str | None = None) -> None:
        check_slice(plan)
        self.plan = plan
        self.device = resolve_device(device)
        self.tables = make_des_tables(plan, device=self.device)
        self.kernel = DesKernel()

    def lam_table(self, keys, overrides: ScenarioOverrides | None = None) -> torch.Tensor:
        """(S, NW) arrival rates: one block of columns per generator, in
        order (``pallas_engine.py:_lam_table``).  With several generators
        the workload overrides are (G,) or (S, G)."""
        plan = self.plan
        ov = overrides if overrides is not None else base_overrides(plan)
        kt = _keys_tensor(keys, self.device)
        if plan.n_generators == 1:
            return lam_table(
                kt, ov.user_mean, ov.req_rate,
                n_windows=plan.n_windows, user_var=plan.user_var,
            )
        um = np.asarray(ov.user_mean, np.float32)
        rr = np.asarray(ov.req_rate, np.float32)
        blocks = [
            lam_table(
                kt, um[..., g], rr[..., g],
                n_windows=nw, user_var=float(plan.gen_user_var[g]), stream=g,
            )
            for g, nw in enumerate(plan.gen_windows)
        ]
        return torch.cat(blocks, dim=1).contiguous()

    def prepare(
        self,
        keys,
        overrides: ScenarioOverrides | None = None,
        lam_table: torch.Tensor | np.ndarray | None = None,
    ) -> tuple:
        """The kernel's arguments ``(tables, k0, k1, lam, em, ev, ed)`` for S
        scenarios, on the engine's device."""
        ov = overrides if overrides is not None else base_overrides(self.plan)
        kt = _keys_tensor(keys, self.device)
        s = kt.shape[0]
        if lam_table is None:
            lam = self.lam_table(kt, ov)
        else:
            lam = _float_tensor(lam_table, self.device)
        k0, k1 = keys_as_int32(kt)
        ne = self.plan.n_edges
        return (
            self.tables,
            k0,
            k1,
            lam,
            _edge_table(ov.edge_mean, s, ne, self.device),
            _edge_table(ov.edge_var, s, ne, self.device),
            _edge_table(ov.edge_dropout, s, ne, self.device),
        )

    def run_batch(
        self,
        keys,
        overrides: ScenarioOverrides | None = None,
        lam_table: torch.Tensor | np.ndarray | None = None,
    ) -> KernelState:
        """Run S scenarios: ``keys`` is (S, 2) (the port's int64 keys or the
        reference's uint32 key data); ``lam_table`` injects the (S, NW)
        arrival rates instead of drawing them."""
        out = self.kernel(*self.prepare(keys, overrides, lam_table))
        hist, thr, momf, momi, trunc, n_events = (x.cpu().numpy() for x in out[:6])
        return KernelState(
            hist=hist,
            lat_count=momi[:, 0],
            lat_sum=momf[:, 0],
            lat_sumsq=momf[:, 1],
            lat_min=momf[:, 2],
            lat_max=momf[:, 3],
            thr=thr,
            clock=np.zeros((1, 2), np.float32),
            clock_n=momi[:, 0],
            n_generated=momi[:, 1],
            n_dropped=momi[:, 2],
            n_overflow=momi[:, 3],
            truncated=trunc.astype(bool),
            llm_sum=momf[:, 4],
            llm_sumsq=momf[:, 5],
            n_rejected=momi[:, 4],
            n_events=n_events,
        )
