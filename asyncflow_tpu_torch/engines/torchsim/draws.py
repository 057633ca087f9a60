"""The scan fast path's per-lane draws: ``jax.random``'s threefry uniforms
and normals in jax's own layout, the edge delay laws, the fused edge hop
with its lane epilogue, and the arrival gaps with XLA's prefix sum, with
the CUDA kernel that computes them (``csrc/edge_draws.cu``).

The plain versions here reproduce, bit for bit where the arithmetic is
exact, what the reference's fast path computes (``asyncflow_tpu/engines/
jaxsim/fastpath.py``: ``_edge_hop`` ``:818``, ``_edge_hop_dyn`` ``:855``,
``_add_spike`` ``:793``, ``_edge_fault`` ``:799``, the fused drop
rescale ``:786``, the gaps and
cumsum of ``_arrivals_stream`` and the raw ``draw_uniform`` streams):

- a stream is a key; lane ``i`` of an ``(n,)`` draw is threefry2x32 of the
  counter ``(0, i)`` under it, and its 32 bits are the two output words
  XORed (``jax._src.prng.threefry_random_bits`` with partitionable
  threefry);
- a uniform is ``bitcast((bits >> 9) | 0x3F800000) - 1`` (``jax.random.
  uniform``'s mantissa construction);
- a normal is ``sqrt(2) * erfinv(u)`` with ``u`` uniform on
  ``[nextafter(-1, 0), 1)`` and XLA's float32 ``erfinv`` polynomial;
- an edge hop drops a lane where ``u < p`` and otherwise rescales the same
  uniform to ``(u - p) / max(1 - p, TINY)`` for the delay law; normal and
  lognormal laws draw ``z`` from the hop key's second stream; under fault
  windows (``_edge_fault``) the row of the edge's fault table active at
  the send time boosts ``p`` (``clip(p + boost, 0, 1)``) and multiplies
  the delay by its factor; the network spike active at the send time is
  added last, and the send time after it (each add rounds the multiply
  before it with it, as the jitted reference does: :class:`Delay`);
- an arrival gap is ``-log1p(-u)`` with XLA's CPU ``log1p`` (Cephes'
  rational form below sqrt(2) - 1 with fused Horner steps, else XLA's CPU
  ``log``, Eigen's ``plog``), and the gaps' prefix sum is XLA's CPU
  ``cumsum``: a recursive scan of 16-lane blocks (:func:`prefix_sum_xla`).
  Both were matched exhaustively against jax on the CPU, so the arrivals
  take the reference's values on every device.

A fused multiply-add of XLA's is computed here as a float64 ``a * b + c``
rounded once to float32 (:func:`fma_xla`: the product is exact in
float64, the sum rounded to odd), and as ``fmaf`` in the kernel: the two
agree on every input.  XLA's CPU compiler contracts a float multiply into
the add that alone consumes it inside one fusion, so the jitted reference
rounds such a pair once; the hop's delay and its sum with the spike or
the send time are such pairs (:class:`Delay`).

:class:`EdgeDraws` is the wrapper: on CUDA tensors it launches the kernel
(built on first use) or raises, on CPU tensors it runs the plain version.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from asyncflow_tpu_torch.engines.torchsim import _build
from asyncflow_tpu_torch.engines.torchsim.keys import MASK32, fold_in, threefry2x32
from asyncflow_tpu_torch.engines.torchsim.sampling import (
    D_EXPONENTIAL,
    D_LOGNORMAL,
    D_NORMAL,
    D_UNIFORM,
    TINY,
    f32,
)
from asyncflow_tpu_torch.errors import KernelBuildError, KernelLaunchError

#: laws that read a standard normal
NORMAL_LAWS = (D_NORMAL, D_LOGNORMAL)
#: the lower end of jax.random.normal's uniform (nextafter(-1, 0))
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = f32(math.sqrt(2.0))

#: XLA's float32 erf_inv polynomial (Giles), for w < 5 and for w >= 5
ERFINV_LT5 = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
ERFINV_GE5 = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(S, n) int64 holding 32 random bits a lane: threefry2x32 of the
    counter (0, i) under each scenario's key, the two words XORed."""
    lane = torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
    y0, y1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], torch.zeros_like(lane), lane)
    return y0 ^ y1


def _mantissa_uniform(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from the high 23 of 32 bits, as jax.random.uniform."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(S, n) ``jax.random.uniform(key, (n,))`` for each scenario's key."""
    return _mantissa_uniform(random_bits(keys, n))


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (the kernel's ``sqrtf``),
    through float64: torch's float32 ``sqrt`` on the CPU has returned
    values off by thousands of ulps for some lanes of large threaded
    calls."""
    return torch.sqrt(x.double()).float()


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` as the jitted reference runs it: in its
    order, its ``log1p`` XLA's and its Horner steps fused."""
    w = -log1p_xla(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt32(w) - 3.0)
    p = torch.where(lt, f32(ERFINV_LT5[0]), f32(ERFINV_GE5[0]))
    for c_lt, c_ge in zip(ERFINV_LT5[1:], ERFINV_GE5[1:]):
        p = fma_xla(p, w, torch.where(lt, f32(c_lt), f32(c_ge)))
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def normal_erfinv(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(S, n) ``erfinv(u)``, u uniform on [nextafter(-1, 0), 1): the normal
    draw of :func:`normal` before its factor sqrt(2)."""
    lo = f32(NORMAL_LO)
    return erfinv_xla(torch.clamp_min(uniform(keys, n) * 2.0 + lo, lo))


def normal(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(S, n) ``jax.random.normal(key, (n,))``: sqrt(2) erfinv(u), u uniform
    on [nextafter(-1, 0), 1)."""
    return SQRT2 * normal_erfinv(keys, n)


class Delay(NamedTuple):
    """An edge delay ``a * b`` whose product is not yet rounded: XLA's CPU
    compiler contracts a delay's last multiply (the exponential law's
    ``-mean * log``, a fault's factor) into the add that consumes it (the
    spike, or the send time), so the jitted reference rounds the two once.
    ``b`` is 1 where the delay's last step is no multiply (1 * a is
    exact, and an add of it is rounded once either way)."""

    a: torch.Tensor
    b: torch.Tensor | float

    def value(self) -> torch.Tensor:
        """The delay alone, its product rounded."""
        return self.a * self.b

    def plus(self, c) -> torch.Tensor:
        """``c + delay``, the product fused into the add."""
        return fma_xla(self.a, self.b, c)


def delay_law(dist: int, mean, var, u: torch.Tensor, e) -> Delay:
    """An edge's delay from its uniform ``u`` (and ``e``, its normal draw
    over sqrt(2): :func:`normal_erfinv`), as ``jaxsim/sampling.py``: uniform
    ignores the mean; normal and lognormal read the variance field as their
    scale, ``mean + var * z``, which XLA's simplifier reassociates to
    ``mean + (var * sqrt(2)) * erfinv`` and its compiler fuses; the
    lognormal's ``exp`` is XLA's (:func:`exp_xla`); the exponential's
    ``-mean * log(..)`` stays unrounded, its ``log`` XLA's (:func:`log_xla`)."""
    if dist == D_UNIFORM:
        return Delay(u, 1.0)
    if dist == D_EXPONENTIAL:
        return Delay(-mean, log_xla(torch.clamp_min(1.0 - u, f32(TINY))))
    if dist == D_NORMAL:
        return Delay(torch.clamp_min(fma_xla(var * SQRT2, e, mean), 0.0), 1.0)
    if dist == D_LOGNORMAL:
        return Delay(exp_xla(fma_xla(var * SQRT2, e, mean)), 1.0)
    msg = f"the fast path draws no edge delay of distribution {dist}"
    raise ValueError(msg)


def hop_laws(dist: np.ndarray, edge: int | None, lb_edge=None) -> list[int]:
    """The delay laws a hop may apply: its static edge's, or with per-lane
    edges the laws of the LB's edges ``lb_edge`` (every law of the plan
    where it is not given; a fast-path plan keeps them free of Poisson
    edges)."""
    if edge is not None:
        return [int(dist[edge])]
    if lb_edge is not None:
        edges = np.asarray(torch.as_tensor(lb_edge).cpu(), np.int64)
        return sorted({int(dist[e]) for e in edges.tolist()})
    return sorted({int(d) for d in np.asarray(dist).tolist()})


#: Cephes' log1p numerator and denominator, highest degree first, as XLA's
#: CPU ``log1p`` evaluates them (Horner's rule with fused steps)
LOG1P_P = (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
    2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1,
)
LOG1P_Q = (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
    3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1,
)
#: below this |x| XLA's log1p takes the rational form (sqrt(2) - 1)
LOG1P_SMALL = f32(0.41421356237309504880)
#: Eigen's plog polynomial (Cephes' logf) and its split ln 2
LOG_P = (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1,
)
LOG_Q1, LOG_Q2 = f32(-2.12194440e-4), f32(0.693359375)
#: lanes a block of XLA's CPU cumsum
SCAN_BLOCK = 16


def fma_xla(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (a fused multiply-add, the
    kernel's ``fmaf``): in float64, where the product of two float32
    values is exact, and the sum rounded to odd (its exact error by
    TwoSum), so that rounding it to float32 rounds the exact value."""
    a, b, c = (torch.as_tensor(x, dtype=torch.float64) if not isinstance(x, torch.Tensor)
               else x.double() for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact = (err != 0) & torch.isfinite(s) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, math.inf, -math.inf)
    return torch.where(inexact, torch.nextafter(s, toward), s).float()


def log_xla(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log``: Eigen's ``plog`` (frexp, a shift to
    [sqrt(1/2), sqrt(2)), Cephes' degree-8 polynomial in three chains),
    with the multiply-adds XLA's compiler fuses."""
    # the mantissa in [0.5, 1) and the exponent: XLA's bit operations
    x, ex = torch.frexp(torch.clamp_min(v, f32(np.finfo(np.float32).tiny)))
    e = ex.float()
    below = x < f32(0.707106781186547524)
    keep = torch.where(below, x, 0.0)
    x = x - 1.0
    e = e - below.float()
    x = x + keep
    x2 = x * x
    x3 = x2 * x
    p = [f32(c) for c in LOG_P]
    y = fma_xla(x, p[0], p[1])
    y1 = fma_xla(x, p[3], p[4])
    y2 = fma_xla(x, p[6], p[7])
    y = fma_xla(y, x, p[2])
    y1 = fma_xla(y1, x, p[5])
    y2 = fma_xla(y2, x, p[8])
    y = fma_xla(y, x3, y1)
    y = fma_xla(y, x3, y2)
    y = fma_xla(y, x3, LOG_Q1 * e)
    x = x - 0.5 * x2
    x = x + y
    x = x + LOG_Q2 * e
    x = torch.where(v == 0.0, -math.inf, x)
    x = torch.where(v == math.inf, math.inf, x)
    return torch.where(v >= 0.0, x, math.nan)


#: XLA's CPU float32 ``exp`` (Cephes' expf): its input clamp, ln 2 split in
#: two, and polynomial, highest degree first
EXP_LO, EXP_HI = f32(-87.8000030517578125), f32(88.8000030517578125)
EXP_LOG2E = f32(1.44269504088896341)
EXP_C1, EXP_C2 = f32(0.693359375), f32(-2.12194440e-4)
EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
         1.6666665459e-1, 5.0000001201e-1)


def exp_xla(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``exp``: the input clamped, ``n = floor(x log2(e) +
    1/2)`` clamped to [-127, 127], ``r = x - n ln 2`` in two fused steps,
    Cephes' degree-5 polynomial by fused Horner steps, ``1 + (r + p r^2)``
    (the inner add fused) times ``2^n`` from the exponent bits."""
    x = torch.clamp(v, EXP_LO, EXP_HI)
    fx = torch.clamp(torch.floor(fma_xla(x, EXP_LOG2E, 0.5)), -127.0, 127.0)
    x = fma_xla(-fx, EXP_C1, x)
    x = fma_xla(-fx, EXP_C2, x)
    y = torch.full_like(x, f32(EXP_P[0]))
    for c in EXP_P[1:]:
        y = fma_xla(y, x, f32(c))
    y = fma_xla(y, x * x, x) + 1.0
    return y * ((fx.to(torch.int32) + 127) << 23).view(torch.float32)


def log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log1p`` (``ElementalIrEmitter::EmitLog1p``):
    ``x + (-0.5 x^2 + x^3 P(x) / Q(x))`` for ``|x| < sqrt(2) - 1``, else
    :func:`log_xla` of ``1 + x``."""
    x2 = x * x
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for cp, cq in zip(LOG1P_P, LOG1P_Q):
        num = fma_xla(num, x, f32(cp))
        den = fma_xla(den, x, f32(cq))
    small = x + (-0.5 * x2 + (x * x2) * (num / den))
    return torch.where(x.abs() < LOG1P_SMALL, small, log_xla(x + 1.0))


def gaps(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(S, n) exponential gaps ``-log1p(-u)`` of each scenario's stream."""
    return -log1p_xla(-uniform(keys, n))


def _block_scan(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The first level of :func:`prefix_sum_xla`: each row cut into
    16-lane blocks, padded with zeros, summed in order in float32.  Returns
    (S, blocks * 16) inclusive block sums and (S, blocks) block totals."""
    s, m = x.shape
    nb = -(-m // SCAN_BLOCK)
    xb = F.pad(x, (0, nb * SCAN_BLOCK - m)).view(s, nb, SCAN_BLOCK)
    loc = torch.empty_like(xb)
    acc = torch.zeros((s, nb), dtype=x.dtype, device=x.device)
    for i in range(SCAN_BLOCK):
        acc = acc + xb[:, :, i]
        loc[:, :, i] = acc
    return loc.view(s, nb * SCAN_BLOCK), acc


def _scan_down(loc: torch.Tensor, inc: torch.Tensor, m: int) -> torch.Tensor:
    """Each block's sums plus the inclusive sum of the blocks before it."""
    s, nb = inc.shape
    exc = F.pad(inc[:, :-1], (1, 0))
    return (loc.view(s, nb, SCAN_BLOCK) + exc[:, :, None]).view(s, nb * SCAN_BLOCK)[:, :m]


def prefix_sum_xla(x: torch.Tensor) -> torch.Tensor:
    """The inclusive prefix sum of each row of ``x`` (S, m) in XLA's CPU
    ``cumsum`` order: 16-lane blocks summed in order, the block totals
    scanned the same way, recursively, and each block's sums plus the
    inclusive sum of the blocks before it."""
    m = x.shape[1]
    loc, tot = _block_scan(x)
    if tot.shape[1] == 1:
        return loc[:, :m]
    return _scan_down(loc, prefix_sum_xla(tot), m)


def drop_rescale(u: torch.Tensor, p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dropped, survivor uniform): ``u < p`` drops, ``(u - p) / max(1 - p,
    TINY)`` is uniform on [0, 1) for the survivors (``_fused_drop_rescale``)."""
    return u < p, (u - p) / torch.clamp_min(1.0 - p, f32(TINY))


def edge_hop_plain(
    u: torch.Tensor,
    zkey: torch.Tensor | None,
    dist: np.ndarray,
    mean: torch.Tensor,
    var: torch.Tensor,
    drop: torch.Tensor,
    *,
    edge: int | None = None,
    eidx: torch.Tensor | None = None,
    laws: list[int] | None = None,
    fault: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, Delay]:
    """(dropped, delay) of S x n lanes crossing one static ``edge`` or, with
    ``eidx`` (S, n), each lane's own edge, whose laws are ``laws`` (every
    law of the plan where not given).  ``u`` is the lanes' uniform;
    ``mean``, ``var`` and ``drop`` are (S, NE); ``dist`` is the plan's
    (NE,) law table; ``zkey`` keys the normal stream (needed where a law
    reads one); ``fault``, where given, is each lane's (latency factor,
    dropout boost), (S, n) each (:func:`fault_lookup`).  Several laws are
    selected lane by lane, which rounds each law's delay (a select stands
    between its multiply and any add)."""
    s, n = u.shape
    laws = hop_laws(dist, edge) if laws is None else laws
    if eidx is None:
        m, v, p = (x[:, edge : edge + 1] for x in (mean, var, drop))
    else:
        m, v, p = (torch.gather(x, 1, eidx.long()) for x in (mean, var, drop))
    if fault is not None:
        p = torch.clamp(p + fault[1], 0.0, 1.0)
    dropped, u_lat = drop_rescale(u, p)
    z = normal_erfinv(zkey, n) if set(laws) & set(NORMAL_LAWS) else None
    if len(laws) == 1:
        delay = delay_law(laws[0], m, v, u_lat, z)
    else:
        law = torch.as_tensor(np.asarray(dist, np.int64), device=u.device)[eidx.long()]
        picked = torch.zeros_like(u)
        for d in laws:
            picked = torch.where(law == d, delay_law(d, m, v, u_lat, z).value(), picked)
        delay = Delay(picked, 1.0)
    if fault is not None:
        delay = Delay(delay.value(), fault[0])
    return dropped, delay


def fault_rows(times: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(S, n) int64 row of a fault table active at each lane's time ``t``:
    ``max(searchsorted(times, t, right) - 1, 0)``, on the table ``times``
    (M,) or on each scenario's row of (S, M); -1 clamps to row 0, and at a
    duplicate time the last row (the superposed state) is read."""
    if times.ndim == 1:
        idx = torch.bucketize(t, times, right=True)
    else:
        idx = torch.searchsorted(times.contiguous(), t.contiguous(), right=True)
    return torch.clamp_min(idx - 1, 0)


def fault_lookup(
    tables: EdgeTables,
    t_send: torch.Tensor,
    *,
    edge: int | None = None,
    eidx: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(latency factor, dropout boost), (S, n) each, of every lane's edge at
    its send time (``_edge_fault``): the static ``edge`` or each lane's
    ``eidx``, from the tables' (M, NE) or (S, M, NE) values."""
    idx = fault_rows(tables.fault_t, t_send)
    out = []
    for vals in (tables.fault_lat, tables.fault_drop):
        if vals.ndim == 2:
            out.append(vals[idx, edge] if eidx is None else vals[idx, eidx.long()])
            continue
        s, m, ne = vals.shape
        if eidx is None:
            out.append(vals[:, :, edge].gather(1, idx))
        else:
            out.append(vals.reshape(s, m * ne).gather(1, idx * ne + eidx.long()))
    return out[0], out[1]


def spike_add(
    delay: Delay,
    t_send: torch.Tensor,
    spike_t: torch.Tensor,
    spike_v: torch.Tensor,
    *,
    edge: int | None = None,
    eidx: torch.Tensor | None = None,
) -> Delay:
    """``delay`` plus the spike active on each lane's edge at its send time
    (``_add_spike``, the delay's product fused into the add): row
    ``searchsorted(spike_t, t_send, right) - 1`` of ``spike_v`` (NB, NE),
    -1 wrapping to the last row as jax indexes."""
    idx = torch.bucketize(t_send, spike_t, right=True) - 1
    idx = torch.where(idx < 0, spike_t.shape[0] - 1, idx)
    spike = spike_v[:, edge][idx] if eidx is None else spike_v[idx, eidx.long()]
    return Delay(delay.plus(spike), 1.0)


#: the kernel's threads a block and lanes a thread (``kThreads``, ``kLanes``)
BLOCK_THREADS, THREAD_LANES = 128, 16


def lane_blocks(n: int) -> int:
    """Lane blocks of a row in the kernel's grid (128 threads x 16 lanes)."""
    return -(-n // (BLOCK_THREADS * THREAD_LANES))


def lane_block_sum(x: torch.Tensor) -> torch.Tensor:
    """(S,) float64 row sums of ``x`` (S, n) float64 in the kernel's order:
    each thread's 16 lanes in order, then a block's 128 threads in order,
    then the row's blocks in order (zeros past the row add nothing)."""
    s, n = x.shape
    nblk = lane_blocks(n)
    xb = F.pad(x, (0, nblk * BLOCK_THREADS * THREAD_LANES - n)).view(
        s, nblk, BLOCK_THREADS, THREAD_LANES)
    per_thread = torch.zeros((s, nblk, BLOCK_THREADS), dtype=x.dtype, device=x.device)
    for i in range(THREAD_LANES):
        per_thread = per_thread + xb[..., i]
    per_block = torch.zeros((s, nblk), dtype=x.dtype, device=x.device)
    for j in range(BLOCK_THREADS):
        per_block = per_block + per_thread[..., j]
    total = torch.zeros(s, dtype=x.dtype, device=x.device)
    for b in range(nblk):
        total = total + per_block[:, b]
    return total


class EdgeTables(NamedTuple):
    """What a hop reads besides its lanes: the plan's (NE,) law table, the
    run's (S, NE) edge parameters, the horizon, the LB's slot tables
    ((K,) int32 edge and server of each slot, or None), the plan's spike
    tables ((NB,) breakpoints, (NB, NE) values, or None without spikes) and
    the run's edge fault tables (float32 breakpoints (M,) or (S, M), their
    first 0, and (M, NE) or (S, M, NE) latency factors and dropout boosts,
    or None without edge faults)."""

    dist: np.ndarray
    mean: torch.Tensor
    var: torch.Tensor
    drop: torch.Tensor
    horizon: float
    lb_edge: torch.Tensor | None = None
    lb_target: torch.Tensor | None = None
    spike_t: torch.Tensor | None = None
    spike_v: torch.Tensor | None = None
    fault_t: torch.Tensor | None = None
    fault_lat: torch.Tensor | None = None
    fault_drop: torch.Tensor | None = None


class HopOut(NamedTuple):
    """A hop's outputs: (S, n) ``t_next`` (the arrival time where ``ok``, else
    the send time) and ``ok`` (sent and not dropped); the LB hop's (S, n)
    int32 ``target`` server (None on a static edge); (S, K) float32 ``span``,
    each edge slot's gauge span, and (S,) int64 ``dropped`` (both None from
    a hop asked for no sums)."""

    t_next: torch.Tensor
    ok: torch.Tensor
    target: torch.Tensor | None
    span: torch.Tensor | None
    dropped: torch.Tensor | None


def hop_plain(
    tables: EdgeTables,
    t_send: torch.Tensor,
    alive: torch.Tensor,
    ukey: torch.Tensor,
    zkey: torch.Tensor | None,
    *,
    edge: int | None = None,
    rank: torch.Tensor | None = None,
    slot: torch.Tensor | None = None,
    sums: bool = True,
) -> HopOut:
    """The fused hop, op by op (``sums`` false: no spans and no drop
    count): lanes where ``alive`` and ``t_send <
    horizon`` send over the static ``edge``; with the arrival ``rank``,
    over LB slot ``rank % K``; with ``slot`` (S, n) int32, over that LB
    slot, a gated lane of slot -1 (no healthy target) counting as dropped
    at the LB and sending nothing (slot 0 on the lanes that do not send);
    the uniform of stream ``ukey`` settles the drop and the delay (under the
    fault row active at ``t_send``, where the tables have fault windows),
    the spike at ``t_send`` is added, and each gauge span is a float64 sum
    in the kernel's order (:func:`lane_block_sum`) rounded once."""
    s, n = t_send.shape
    h = f32(tables.horizon)
    gate = alive & (t_send < h)
    lb_dropped = torch.zeros(s, dtype=torch.int64, device=t_send.device)
    if rank is None and slot is None:
        pick, k_slots, eidx, target = None, 1, None, None
    else:
        k_slots = tables.lb_edge.shape[0]
        if slot is None:
            pick = torch.where(gate, rank % k_slots, 0)
        else:
            unrouted = gate & (slot < 0)
            lb_dropped = unrouted.sum(dim=1)
            gate = gate & ~unrouted
            pick = torch.where(gate, slot.long(), 0)
        eidx = tables.lb_edge.long()[pick]
        target = tables.lb_target[pick]
    laws = hop_laws(tables.dist, edge, None if edge is not None else tables.lb_edge)
    needs_z = bool(set(laws) & set(NORMAL_LAWS))
    fault = (None if tables.fault_t is None
             else fault_lookup(tables, t_send, edge=edge, eidx=eidx))
    dropped, delay = edge_hop_plain(
        uniform(ukey, n), zkey if needs_z else None, tables.dist, tables.mean, tables.var,
        tables.drop, edge=edge, eidx=eidx, laws=laws, fault=fault,
    )
    if tables.spike_t is not None:
        delay = spike_add(delay, t_send, tables.spike_t, tables.spike_v, edge=edge, eidx=eidx)
    ok = gate & ~dropped
    if not sums:
        # least connections' candidates: the reference stacks the slots'
        # delays before it adds the send time, so it rounds them first
        t_end = t_send + delay.value()
        return HopOut(t_next=torch.where(ok, t_end, t_send), ok=ok, target=target, span=None,
                      dropped=None)
    t_end = delay.plus(t_send)
    lane_span = torch.where(
        ok, torch.clamp_min(torch.clamp_max(t_end, h) - torch.clamp_max(t_send, h), 0.0), 0.0,
    ).double()
    if pick is None:
        span = lane_block_sum(lane_span)[:, None]
    else:
        span = torch.stack(
            [lane_block_sum(torch.where(pick == k, lane_span, 0.0)) for k in range(k_slots)],
            dim=1,
        )
    return HopOut(
        t_next=torch.where(ok, t_end, t_send),
        ok=ok,
        target=target,
        span=span.float(),
        dropped=(gate & dropped).sum(dim=1) + lb_dropped,
    )


def candidates_plain(
    tables: EdgeTables,
    t_send: torch.Tensor,
    alive: torch.Tensor,
    ukeys: torch.Tensor,
    zkeys: torch.Tensor | None,
    edges: list[int],
) -> tuple[torch.Tensor, torch.Tensor]:
    """Least connections' candidates: each slot's hop without sums of the
    lanes ``alive`` sending at ``t_send`` (S, n), slot k over static edge
    ``edges[k]`` keyed ``ukeys[:, k]`` (and ``zkeys[:, k]``), stacked into
    (S, n, K) ``t_next`` and ``ok``."""
    hops = [hop_plain(tables, t_send, alive, ukeys[:, k],
                      None if zkeys is None else zkeys[:, k], edge=e, sums=False)
            for k, e in enumerate(edges)]
    return (torch.stack([h.t_next for h in hops], dim=2),
            torch.stack([h.ok for h in hops], dim=2))


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

MODE_UNIFORM = 0
MODE_HOP = 1
MODE_GAPS = 2
MODE_CANDIDATES = 3
#: LB slots the hop takes (its per-thread gauge accumulators in shared memory)
MAX_LB_SLOTS = 32


class _EdgeDrawArgs(ctypes.Structure):
    """Mirror of ``struct EdgeDrawArgs`` in edge_draws.cu (same order)."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "ukey", "zkey", "x_in", "t_send", "alive", "rank", "slot", "lb_edge", "lb_target",
            "mean", "var", "drop", "dist", "spike_t", "spike_v", "fault_t", "fault_lat",
            "fault_drop", "out", "ok", "target", "partial", "span", "dropped",
        )]
        + [(name, ctypes.c_int64) for name in ("S", "n", "ld_out")]
        + [("horizon", ctypes.c_float)]
        + [(name, ctypes.c_int32) for name in (
            "NE", "NB", "K", "edge", "mode", "gap", "NF", "fault_per_row")]
    )


def _library() -> ctypes.CDLL:
    lib = _build.load("edge_draws")
    lib.edge_draws_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.edge_draws_launch.restype = ctypes.c_int
    lib.edge_draws_args_size.argtypes = []
    lib.edge_draws_args_size.restype = ctypes.c_int
    lib.edge_draws_lane_block.argtypes = []
    lib.edge_draws_lane_block.restype = ctypes.c_int
    if lib.edge_draws_args_size() != ctypes.sizeof(_EdgeDrawArgs):
        msg = "EdgeDrawArgs layout mismatch between edge_draws.cu and its ctypes mirror"
        raise KernelBuildError(msg)
    if lib.edge_draws_lane_block() != BLOCK_THREADS * THREAD_LANES:
        msg = "edge_draws.cu's lanes a block differ from lane_block_sum's"
        raise KernelBuildError(msg)
    return lib


def key_words(keys: torch.Tensor) -> torch.Tensor:
    """(S, 2) int32 holding each key's two 32-bit words (the kernel's input)."""
    k = keys & MASK32
    return torch.where(k >= 2**31, k - 2**32, k).to(torch.int32).contiguous()


def _need(x: torch.Tensor, dtype: torch.dtype, shape: tuple, dev, name: str) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() or x.device != dev:
        msg = (
            f"edge_draws: {name} must be a contiguous {dtype} tensor of shape {shape} on "
            f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}"
        )
        raise ValueError(msg)


class PlainEdgeDraws:
    """The plain versions behind :class:`EdgeDraws`' interface, on any
    device: what a check on the card holds the kernel to.  The engine's
    own path never takes it."""

    def uniform(self, keys: torch.Tensor, n: int, *, gap: bool = False) -> torch.Tensor:
        return gaps(keys, n) if gap else uniform(keys, n)

    def gap_cumsum(self, keys: torch.Tensor, n: int) -> torch.Tensor:
        return F.pad(prefix_sum_xla(gaps(keys, n)), (1, 0))

    def gap_of(self, u: torch.Tensor) -> torch.Tensor:
        return -log1p_xla(-u)

    def hop(self, tables, t_send, alive, ukey, zkey, *, edge=None, rank=None,
            slot=None) -> HopOut:
        return hop_plain(tables, t_send, alive, ukey, zkey, edge=edge, rank=rank, slot=slot)

    def candidates(self, tables, t_send, alive, ukeys, zkeys, edges):
        return candidates_plain(tables, t_send, alive, ukeys, zkeys, edges)


class EdgeDraws:
    """The per-lane draws of the fast path with their launch count, in all
    (``launches``), of hops under fault tables (``fault_launches``) and of
    least connections' candidates (``cand_launches``)."""

    name = "edge_draws"
    route = "cuda"
    source = "asyncflow_tpu_torch/csrc/edge_draws.cu"
    replaces = (
        "asyncflow_tpu/engines/jaxsim/fastpath.py:818 (_edge_hop), :855 (_edge_hop_dyn), "
        ":793 (_add_spike), :799 (_edge_fault), :980-981 (the arrival gaps and their "
        "cumsum), :986 (the windows' extra gaps), :1388 and :1393 (draw_uniform)"
    )

    def __init__(self) -> None:
        self.launches = 0
        self.fault_launches = 0
        self.cand_launches = 0

    def uniform(self, keys: torch.Tensor, n: int, *, gap: bool = False) -> torch.Tensor:
        """(S, n) uniforms of each scenario's stream ``keys`` (S, 2), or
        with ``gap`` the exponential gaps ``-log1p(-u)``."""
        if keys.device.type == "cpu":
            return PlainEdgeDraws().uniform(keys, n, gap=gap)
        s = keys.shape[0]
        out = torch.empty((s, n), dtype=torch.float32, device=keys.device)
        self._launch(MODE_UNIFORM, s, n, ukey=key_words(keys), out=out, gap=int(gap))
        return out

    def gap_of(self, u: torch.Tensor) -> torch.Tensor:
        """(S, n) gaps ``-log1p(-u)`` of the given float32 uniforms: the
        uniform mode on given inputs, the check of :func:`log1p_xla`."""
        if u.device.type == "cpu":
            return PlainEdgeDraws().gap_of(u)
        s, n = u.shape
        _need(u, torch.float32, (s, n), u.device, "u")
        out = torch.empty_like(u)
        self._launch(MODE_UNIFORM, s, n, x_in=u, out=out, gap=1)
        return out

    def gap_cumsum(self, keys: torch.Tensor, n: int) -> torch.Tensor:
        """(S, n + 1): a zero, then the prefix sums of the exponential gaps
        of stream ``keys`` in XLA's order (:func:`prefix_sum_xla`); the
        kernel draws the gaps and computes every level of the sum in one
        launch, a block a row, writing each lane once."""
        if keys.device.type == "cpu":
            return PlainEdgeDraws().gap_cumsum(keys, n)
        s = keys.shape[0]
        out = torch.empty((s, n + 1), dtype=torch.float32, device=keys.device)
        self._launch(MODE_GAPS, s, n, ukey=key_words(keys), out=out, ld_out=n + 1)
        return out

    def hop(
        self,
        tables: EdgeTables,
        t_send: torch.Tensor,
        alive: torch.Tensor,
        ukey: torch.Tensor,
        zkey: torch.Tensor | None,
        *,
        edge: int | None = None,
        rank: torch.Tensor | None = None,
        slot: torch.Tensor | None = None,
    ) -> HopOut:
        """The fused hop (:func:`hop_plain`) of the lanes ``t_send`` (S, n)
        float32 and ``alive`` (S, n) bool, over the static ``edge``, the LB
        slots of the int64 arrival ``rank``, or the int32 LB ``slot`` of
        each lane (-1: no healthy target); ``ukey`` (S, 2) keys the
        uniform stream, ``zkey`` the normal one where a law reads it; the
        fault tables of ``tables``, where given, are read in the kernel at
        each lane's send time."""
        if sum(x is not None for x in (edge, rank, slot)) != 1:
            msg = "edge_draws.hop takes exactly one of edge, rank and slot"
            raise ValueError(msg)
        needs_z = bool(set(hop_laws(tables.dist, edge)) & set(NORMAL_LAWS))
        if needs_z and zkey is None:
            msg = "edge_draws.hop: a normal or lognormal edge needs its z stream key"
            raise ValueError(msg)
        dev = t_send.device
        if dev.type == "cpu":
            return PlainEdgeDraws().hop(tables, t_send, alive, ukey, zkey, edge=edge, rank=rank,
                                        slot=slot)
        s, n = t_send.shape
        k_slots = 1
        target = None
        if edge is None:
            if rank is not None:
                _need(rank, torch.int64, (s, n), dev, "rank")
            else:
                _need(slot, torch.int32, (s, n), dev, "slot")
            k_slots = int(tables.lb_edge.shape[0])
            _need(tables.lb_target, torch.int32, (k_slots,), dev, "lb_target")
            target = torch.empty((s, n), dtype=torch.int32, device=dev)
        fields = self._hop_fields(tables, t_send, alive, k_slots,
                                  lb_edge=tables.lb_edge if edge is None else None)
        out = HopOut(
            t_next=torch.empty((s, n), dtype=torch.float32, device=dev),
            ok=torch.empty((s, n), dtype=torch.bool, device=dev),
            target=target,
            span=torch.empty((s, k_slots), dtype=torch.float32, device=dev),
            dropped=torch.empty(s, dtype=torch.int64, device=dev),
        )
        partial = torch.empty((s, lane_blocks(n), k_slots + 1), dtype=torch.float64, device=dev)
        self._launch(
            MODE_HOP, s, n, **fields,
            ukey=key_words(ukey), zkey=key_words(zkey) if needs_z else None,
            rank=rank, slot=slot, lb_target=tables.lb_target if edge is None else None,
            out=out.t_next, ok=out.ok, target=target, partial=partial, span=out.span,
            dropped=out.dropped, edge=-1 if edge is None else int(edge),
        )
        return out

    def candidates(
        self,
        tables: EdgeTables,
        t_send: torch.Tensor,
        alive: torch.Tensor,
        ukeys: torch.Tensor,
        zkeys: torch.Tensor | None,
        edges: list[int],
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Least connections' candidates (:func:`candidates_plain`): each
        lane of ``t_send`` (S, n) float32 and ``alive`` (S, n) bool hopped
        over every slot's static edge ``edges[k]``, slot k keyed by
        ``ukeys[:, k]`` (and ``zkeys[:, k]`` where a law reads a normal),
        (S, K, 2) each; returns (S, n, K) ``t_next`` and ``ok``, in one
        launch (the fault and spike rows searched once a lane)."""
        k_slots, ne = len(edges), tables.mean.shape[1]
        if not 0 < k_slots <= MAX_LB_SLOTS or not all(0 <= e < ne for e in edges):
            msg = (f"edge_draws.candidates takes 1 to {MAX_LB_SLOTS} edges of the plan's {ne}, "
                   f"got {edges}")
            raise ValueError(msg)
        needs_z = any(int(tables.dist[e]) in NORMAL_LAWS for e in edges)
        if needs_z and zkeys is None:
            msg = "edge_draws.candidates: a normal or lognormal edge needs its z stream keys"
            raise ValueError(msg)
        dev = t_send.device
        if dev.type == "cpu":
            return PlainEdgeDraws().candidates(tables, t_send, alive, ukeys, zkeys, edges)
        s, n = t_send.shape
        for name, keys in (("ukeys", ukeys), ("zkeys", zkeys if needs_z else None)):
            if keys is not None and tuple(keys.shape) != (s, k_slots, 2):
                msg = (f"edge_draws.candidates: {name} must be ({s}, {k_slots}, 2), got "
                       f"{tuple(keys.shape)}")
                raise ValueError(msg)
        lb_edge = torch.as_tensor(np.asarray(edges, np.int32), device=dev)
        fields = self._hop_fields(tables, t_send, alive, k_slots, lb_edge=lb_edge)
        t_next = torch.empty((s, n, k_slots), dtype=torch.float32, device=dev)
        ok = torch.empty((s, n, k_slots), dtype=torch.bool, device=dev)
        self._launch(
            MODE_CANDIDATES, s, n, **fields,
            ukey=key_words(ukeys), zkey=key_words(zkeys) if needs_z else None,
            out=t_next, ok=ok,
        )
        return t_next, ok

    def _hop_fields(self, tables: EdgeTables, t_send, alive, k_slots: int, lb_edge) -> dict:
        """The arguments every hop mode passes: the lanes, the slots' edges,
        the edge parameters, the law table and the spike and fault tables,
        each checked."""
        s, n = t_send.shape
        dev = t_send.device
        ne = tables.mean.shape[1]
        _need(t_send, torch.float32, (s, n), dev, "t_send")
        _need(alive, torch.bool, (s, n), dev, "alive")
        for name in ("mean", "var", "drop"):
            _need(getattr(tables, name), torch.float32, (s, ne), dev, name)
        if lb_edge is not None:
            if k_slots > MAX_LB_SLOTS:
                msg = f"edge_draws takes at most {MAX_LB_SLOTS} LB edges, got {k_slots}"
                raise ValueError(msg)
            _need(lb_edge, torch.int32, (k_slots,), dev, "lb_edge")
        nb = 0
        if tables.spike_t is not None:
            nb = int(tables.spike_t.shape[0])
            _need(tables.spike_t, torch.float32, (nb,), dev, "spike_t")
            _need(tables.spike_v, torch.float32, (nb, ne), dev, "spike_v")
        nf, per_row = 0, 0
        if tables.fault_t is not None:
            per_row = int(tables.fault_t.ndim == 2)
            nf = int(tables.fault_t.shape[-1])
            rows = (s,) if per_row else ()
            _need(tables.fault_t, torch.float32, (*rows, nf), dev, "fault_t")
            for name in ("fault_lat", "fault_drop"):
                _need(getattr(tables, name), torch.float32, (*rows, nf, ne), dev, name)
        return {
            "t_send": t_send, "alive": alive, "lb_edge": lb_edge,
            "mean": tables.mean, "var": tables.var, "drop": tables.drop,
            "dist": torch.as_tensor(np.asarray(tables.dist, np.int32), device=dev),
            "spike_t": tables.spike_t, "spike_v": tables.spike_v,
            "fault_t": tables.fault_t, "fault_lat": tables.fault_lat,
            "fault_drop": tables.fault_drop,
            "horizon": f32(tables.horizon), "NE": ne, "NB": nb, "K": k_slots, "NF": nf,
            "fault_per_row": per_row,
        }

    _SCALARS = ("ld_out", "horizon", "NE", "NB", "K", "edge", "gap", "NF",
                "fault_per_row")

    def _launch(self, mode: int, s: int, n: int, **fields) -> None:
        if s == 0 or n == 0:
            return
        tensors = {k: v for k, v in fields.items() if k not in self._SCALARS}
        dev = next(t.device for t in tensors.values() if isinstance(t, torch.Tensor))
        if dev.type != "cuda":
            msg = f"edge_draws runs on cuda or cpu tensors, got {dev}"
            raise ValueError(msg)
        lib = _library()
        args = _EdgeDrawArgs(S=s, n=n, mode=mode, edge=-1, K=1)
        for name in self._SCALARS:
            if name in fields:
                setattr(args, name, fields[name])
        for name, t in tensors.items():
            if t is not None:
                setattr(args, name, t.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.edge_draws_launch(ctypes.byref(args), ctypes.c_void_p(stream))
        if rc != 0:
            msg = f"edge_draws launch failed: code {rc}"
            raise KernelLaunchError(msg)
        self.launches += 1
        if fields.get("fault_t") is not None:
            self.fault_launches += 1
        if mode == MODE_CANDIDATES:
            self.cand_launches += 1


def hop_keys(keys: torch.Tensor, site: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(u stream, z stream) of a hop keyed ``fold_in(key, site)``: the
    hop's ``fold_in(., 0)`` and ``fold_in(., 2)``."""
    hop = fold_in(keys, site)
    return fold_in(hop, 0), fold_in(hop, 2)
