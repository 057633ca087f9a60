"""PyTorch / CUDA port of asyncflow-tpu for NVIDIA Hopper cards.

The JAX package (``asyncflow_tpu``) is the reference; this package imports
nothing of it.  It ports the event-kernel sweep path:

    payload -> compile_payload -> KernelEngine.run_batch -> SweepResults

where the Pallas DES kernel of the reference is a hand-written CUDA kernel
(``csrc/des_kernel.cu``) with a plain PyTorch twin
(``engines/torchsim/des_reference.py``); slice 2 added event injection,
the server overload controls and the LB circuit breaker, and slice 3 cache
mixtures, LLM call dynamics, DB connection pools and several generators,
which completes the kernel.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; with no device given and no GPU present
they raise :class:`~asyncflow_tpu_torch.errors.NoDeviceError`.
"""

from asyncflow_tpu_torch.errors import (
    KernelBuildError,
    KernelLaunchError,
    NoDeviceError,
    PayloadError,
    ProofHeadroomError,
    UnsupportedFeatureError,
)

__all__ = [
    "KernelBuildError",
    "KernelLaunchError",
    "NoDeviceError",
    "PayloadError",
    "ProofHeadroomError",
    "UnsupportedFeatureError",
]
