"""PyTorch / CUDA port of asyncflow-tpu for NVIDIA Hopper cards.

The JAX package (``asyncflow_tpu``) is the reference; this package imports
nothing of it.  It ports the event-kernel sweep path:

    payload -> compile_payload -> KernelEngine.run_batch -> SweepResults

where the Pallas DES kernel of the reference is a hand-written CUDA kernel
(``csrc/des_kernel.cu``) with a plain PyTorch twin
(``engines/torchsim/des_reference.py``); slice 2 added event injection,
the server overload controls and the LB circuit breaker, and slice 3 cache
mixtures, LLM call dynamics, DB connection pools and several generators,
which completes the kernel.  Slice 5 added the reference's scan fast path
for single-generator round-robin plans:

    payload -> compile_payload -> FastEngine.run_batch -> SweepResults

with the per-lane draws (``csrc/edge_draws.cu``) and the FIFO station
recursions (``csrc/station_scan.cu``) as hand-written CUDA kernels;
``SweepRunner(engine="auto")`` takes it where the reference would and the
slice allows.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no device given and no GPU present they raise
:class:`~asyncflow_tpu_torch.errors.NoDeviceError`.
"""

from asyncflow_tpu_torch.errors import (
    FastPathIneligibleError,
    FastPathOverrideError,
    KernelBuildError,
    KernelLaunchError,
    NoDeviceError,
    PayloadError,
    ProofHeadroomError,
    UnsupportedFeatureError,
)

__all__ = [
    "FastPathIneligibleError",
    "FastPathOverrideError",
    "KernelBuildError",
    "KernelLaunchError",
    "NoDeviceError",
    "PayloadError",
    "ProofHeadroomError",
    "UnsupportedFeatureError",
]
