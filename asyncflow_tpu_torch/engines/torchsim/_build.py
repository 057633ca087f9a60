"""Build the CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

Each source is compiled on first use into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), named by a digest
of its source and flags so that a stale build is never reused.  The build
directory is ``build/torch_kernels/`` at the root of the checkout.
:func:`build` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from asyncflow_tpu_torch.errors import KernelBuildError

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCES = {"des_kernel": CSRC / "des_kernel.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
#: what ptxas reported (registers, spills) for each library built here
ptxas_report: dict[str, str] = {}


BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    msg = "nvcc not found (put the CUDA toolkit's bin directory on PATH)"
    raise KernelBuildError(msg)


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (all by default) that have no current
    build, one nvcc process each, started together."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: dict[str, tuple[subprocess.Popen, Path, Path]] = {}
    try:
        for name in names:
            target = library_path(name)
            if target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
            procs[name] = (
                subprocess.Popen(  # noqa: S603 - fixed argv, no shell
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                ),
                tmp,
                target,
            )
        failed = []
        for name, (proc, tmp, target) in procs.items():
            log, _ = proc.communicate()
            ptxas_report[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            else:
                tmp.replace(target)
        if failed:
            raise KernelBuildError("\n".join(failed))
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if need be."""
    if name not in _loaded:
        path = build([name])[name]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
