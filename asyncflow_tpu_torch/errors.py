"""Named errors of the port."""

from __future__ import annotations

ROADMAP_HINT = "see ROADMAP.md, queue A, for the order in which the port grows"


class PayloadError(ValueError):
    """A scenario payload failed validation."""


class UnsupportedFeatureError(PayloadError):
    """The payload or plan uses a feature this slice of the port does not
    model.  Raised instead of ignoring the feature, and before any launch."""

    def __init__(self, feature: str, where: str = "") -> None:
        self.feature = feature
        at = f" ({where})" if where else ""
        super().__init__(
            f"{feature!r}{at} is not modelled by asyncflow_tpu_torch yet; "
            f"{ROADMAP_HINT}",
        )


class FastPathIneligibleError(PayloadError):
    """The plan is outside the scan fast path's model, by the compiler's own
    analysis (``plan.fastpath_reason`` says why); the DES kernel runs it."""


class FastPathOverrideError(ValueError):
    """Sweep overrides move the workload outside what the fast path's
    compile-time proofs cover (a non-binding RAM tier, the multi-burst
    relaxation envelope, a breaker lowered away at zero LB dropout)."""


class ProofHeadroomError(ValueError):
    """Sweep overrides scale the workload past ``plan.proof_rate_headroom``:
    an overload control that the compiler proved unreachable at the base
    rate, and lowered away, could bind at the overridden rate."""


class NoDeviceError(RuntimeError):
    """No device was given and no CUDA device is present.  The port never
    falls back to the CPU on its own: pass ``device="cpu"`` to ask for it."""


class KernelBuildError(RuntimeError):
    """A CUDA source could not be compiled or loaded."""


class KernelLaunchError(RuntimeError):
    """A kernel launch was refused (``cudaGetLastError`` was not 0)."""
