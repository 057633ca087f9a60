"""The scan fast path's per-lane draws: ``jax.random``'s threefry uniforms
and normals in jax's own layout, the edge delay laws, and the fused
dropout / delay hop, with the CUDA kernel that computes them
(``csrc/edge_draws.cu``).

The plain versions here reproduce, bit for bit where the arithmetic is
exact, what the reference's fast path draws (``asyncflow_tpu/engines/
jaxsim/fastpath.py``: ``_edge_hop`` ``:818``, ``_edge_hop_dyn`` ``:855``,
the fused drop rescale ``:786`` and the raw ``draw_uniform`` streams of
``_arrivals_stream`` and ``_journey``):

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
  lognormal laws draw ``z`` from the hop key's second stream.

:class:`EdgeDraws` is the wrapper: on CUDA tensors it launches the kernel
(built on first use) or raises, on CPU tensors it runs the plain version.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

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
    """XLA's float32 ``erf_inv``: one operation at a time, in its order."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt32(w) - 3.0)
    p = torch.where(lt, f32(ERFINV_LT5[0]), f32(ERFINV_GE5[0]))
    for c_lt, c_ge in zip(ERFINV_LT5[1:], ERFINV_GE5[1:]):
        p = torch.where(lt, f32(c_lt), f32(c_ge)) + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def normal(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(S, n) ``jax.random.normal(key, (n,))``: sqrt(2) erfinv(u), u uniform
    on [nextafter(-1, 0), 1)."""
    lo = f32(NORMAL_LO)
    u = torch.clamp_min(uniform(keys, n) * 2.0 + lo, lo)
    return SQRT2 * erfinv_xla(u)


def delay_law(dist: int, mean, var, u: torch.Tensor, z) -> torch.Tensor:
    """An edge's delay from its uniform ``u`` (and normal ``z``), as
    ``jaxsim/sampling.py``: uniform ignores the mean; normal and lognormal
    read the variance field as their scale."""
    if dist == D_UNIFORM:
        return u
    if dist == D_EXPONENTIAL:
        return -mean * torch.log(torch.clamp_min(1.0 - u, f32(TINY)))
    if dist == D_NORMAL:
        return torch.clamp_min(mean + var * z, 0.0)
    if dist == D_LOGNORMAL:
        return torch.exp(mean + var * z)
    msg = f"the fast path draws no edge delay of distribution {dist}"
    raise ValueError(msg)


def hop_laws(dist: np.ndarray, edge: int | None) -> list[int]:
    """The delay laws a hop may apply: its static edge's, or with per-lane
    edges every law of the plan (which a fast-path plan keeps free of
    Poisson edges)."""
    if edge is not None:
        return [int(dist[edge])]
    return sorted({int(d) for d in np.asarray(dist).tolist()})


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dropped, delay) of S x n lanes crossing one static ``edge`` or, with
    ``eidx`` (S, n), each lane's own edge.  ``u`` is the lanes' uniform;
    ``mean``, ``var`` and ``drop`` are (S, NE); ``dist`` is the plan's
    (NE,) law table; ``zkey`` keys the normal stream (needed where a law
    reads one)."""
    s, n = u.shape
    laws = hop_laws(dist, edge)
    if eidx is None:
        m, v, p = (x[:, edge : edge + 1] for x in (mean, var, drop))
    else:
        m, v, p = (torch.gather(x, 1, eidx.long()) for x in (mean, var, drop))
    dropped, u_lat = drop_rescale(u, p)
    z = normal(zkey, n) if set(laws) & set(NORMAL_LAWS) else None
    if len(laws) == 1:
        return dropped, delay_law(laws[0], m, v, u_lat, z)
    law = torch.as_tensor(np.asarray(dist, np.int64), device=u.device)[eidx.long()]
    delay = torch.zeros_like(u)
    for d in laws:
        delay = torch.where(law == d, delay_law(d, m, v, u_lat, z), delay)
    return dropped, delay


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

MODE_UNIFORM = 0
MODE_HOP = 1


class _EdgeDrawArgs(ctypes.Structure):
    """Mirror of ``struct EdgeDrawArgs`` in edge_draws.cu (same order)."""

    _fields_ = (
        [(name, ctypes.c_void_p) for name in (
            "ukey", "zkey", "u_in", "eidx", "mean", "var", "drop", "dist",
            "u_out", "dropped", "delay",
        )]
        + [(name, ctypes.c_int64) for name in ("S", "n")]
        + [(name, ctypes.c_int32) for name in ("NE", "edge", "mode")]
    )


def _library() -> ctypes.CDLL:
    lib = _build.load("edge_draws")
    lib.edge_draws_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.edge_draws_launch.restype = ctypes.c_int
    lib.edge_draws_args_size.argtypes = []
    lib.edge_draws_args_size.restype = ctypes.c_int
    if lib.edge_draws_args_size() != ctypes.sizeof(_EdgeDrawArgs):
        msg = "EdgeDrawArgs layout mismatch between edge_draws.cu and its ctypes mirror"
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

    def uniform(self, keys: torch.Tensor, n: int) -> torch.Tensor:
        return uniform(keys, n)

    def hop(self, keys, zkey, dist, mean, var, drop, n, *, u=None, edge=None, eidx=None):
        needs_z = bool(set(hop_laws(dist, edge)) & set(NORMAL_LAWS))
        uu = uniform(keys, n) if u is None else u
        return edge_hop_plain(uu, zkey if needs_z else None, dist, mean, var, drop,
                              edge=edge, eidx=eidx)


class EdgeDraws:
    """The per-lane draws of the fast path with their launch count."""

    name = "edge_draws"
    route = "cuda"
    source = "asyncflow_tpu_torch/csrc/edge_draws.cu"
    replaces = (
        "asyncflow_tpu/engines/jaxsim/fastpath.py:818 (_edge_hop), :855 (_edge_hop_dyn), "
        ":980 and :986 (draw_uniform)"
    )

    def __init__(self) -> None:
        self.launches = 0

    def uniform(self, keys: torch.Tensor, n: int) -> torch.Tensor:
        """(S, n) uniforms of each scenario's stream ``keys`` (S, 2)."""
        if keys.device.type == "cpu":
            return uniform(keys, n)
        s = keys.shape[0]
        out = torch.empty((s, n), dtype=torch.float32, device=keys.device)
        self._launch(MODE_UNIFORM, s, n, ukey=key_words(keys), u_out=out)
        return out

    def hop(
        self,
        keys: torch.Tensor | None,
        zkey: torch.Tensor | None,
        dist: np.ndarray,
        mean: torch.Tensor,
        var: torch.Tensor,
        drop: torch.Tensor,
        n: int,
        *,
        u: torch.Tensor | None = None,
        edge: int | None = None,
        eidx: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(dropped, delay) of ``n`` lanes a scenario over one static
        ``edge`` or the lanes' own edges ``eidx``; the uniform is the stream
        ``keys`` (S, 2) or the given ``u`` (S, n)."""
        dev = mean.device
        if (edge is None) == (eidx is None):
            msg = "edge_draws.hop takes exactly one of edge and eidx"
            raise ValueError(msg)
        needs_z = bool(set(hop_laws(dist, edge)) & set(NORMAL_LAWS))
        if needs_z and zkey is None:
            msg = "edge_draws.hop: a normal or lognormal edge needs its z stream key"
            raise ValueError(msg)
        if dev.type == "cpu":
            return PlainEdgeDraws().hop(keys, zkey, dist, mean, var, drop, n, u=u,
                                        edge=edge, eidx=eidx)
        s, ne = mean.shape
        for name, x in (("mean", mean), ("var", var), ("drop", drop)):
            _need(x, torch.float32, (s, ne), dev, name)
        if u is not None:
            _need(u, torch.float32, (s, n), dev, "u")
        if eidx is not None:
            _need(eidx, torch.int32, (s, n), dev, "eidx")
        dropped = torch.empty((s, n), dtype=torch.bool, device=dev)
        delay = torch.empty((s, n), dtype=torch.float32, device=dev)
        self._launch(
            MODE_HOP, s, n,
            ukey=None if u is not None else key_words(keys),
            zkey=key_words(zkey) if needs_z else None,
            u_in=u, eidx=eidx, mean=mean, var=var, drop=drop,
            dist=torch.as_tensor(np.asarray(dist, np.int32), device=dev),
            dropped=dropped, delay=delay,
            NE=ne, edge=-1 if edge is None else int(edge),
        )
        return dropped, delay

    def _launch(self, mode: int, s: int, n: int, **tensors) -> None:
        if s == 0 or n == 0:
            return
        dev = next(t.device for t in tensors.values() if isinstance(t, torch.Tensor))
        if dev.type != "cuda":
            msg = f"edge_draws runs on cuda or cpu tensors, got {dev}"
            raise ValueError(msg)
        lib = _library()
        args = _EdgeDrawArgs(S=s, n=n, NE=tensors.pop("NE", 0),
                             edge=tensors.pop("edge", -1), mode=mode)
        for name, t in tensors.items():
            if t is not None:
                setattr(args, name, t.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.edge_draws_launch(ctypes.byref(args), ctypes.c_void_p(stream))
        if rc != 0:
            msg = f"edge_draws launch failed: code {rc}"
            raise KernelLaunchError(msg)
        self.launches += 1


def hop_keys(keys: torch.Tensor, site: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(u stream, z stream) of a hop keyed ``fold_in(key, site)``: the
    hop's ``fold_in(., 0)`` and ``fold_in(., 2)``."""
    hop = fold_in(keys, site)
    return fold_in(hop, 0), fold_in(hop, 2)
