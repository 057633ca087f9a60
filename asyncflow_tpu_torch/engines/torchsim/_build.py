"""Build the CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

Each library is compiled on first use from one source and its own
defines into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), named by a digest of its source and
flags so that a stale build is never reused.  The build directory is
``build/torch_kernels/`` at the root of the checkout.  :func:`build` starts
one nvcc per library, all at once, and keeps each library's ``ptxas -v``
log beside it (``.ptxas``), so that a build found there reports its
registers and spills as a fresh one does.
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
#: library name -> (source, extra nvcc flags): the DES kernel is built twice,
#: without and with its workload group of instances; the fast path's four
#: kernels once each
SOURCES = {
    "des_kernel": (CSRC / "des_kernel.cu", ("-DDES_WORKLOAD=0",)),
    "des_kernel_workload": (CSRC / "des_kernel.cu", ("-DDES_WORKLOAD=1",)),
    "edge_draws": (CSRC / "edge_draws.cu", ()),
    "station_scan": (CSRC / "station_scan.cu", ()),
    "lb_route": (CSRC / "lb_route.cu", ()),
    "gauge_grid": (CSRC / "gauge_grid.cu", ()),
}
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
#: what ptxas reported (registers, spills) for each library that
#: :func:`build` built or found built
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
    src, defines = SOURCES[name]
    flags = " ".join((*NVCC_FLAGS, *defines))
    digest = hashlib.sha256(src.read_bytes() + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (all by default) that have no current
    build, one nvcc process each, started together; a current build's
    ptxas log is read back into :data:`ptxas_report`."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: dict[str, tuple[subprocess.Popen, Path, Path]] = {}
    try:
        for name in names:
            target = library_path(name)
            log_path = target.with_suffix(".ptxas")
            if target.exists() and log_path.exists():
                ptxas_report[name] = log_path.read_text()
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            src, defines = SOURCES[name]
            cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-o", str(tmp), str(src)]
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
                # the log first: a library is current only with its log
                log_tmp = tmp.with_suffix(".ptxas")
                log_tmp.write_text(log)
                log_tmp.replace(target.with_suffix(".ptxas"))
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
