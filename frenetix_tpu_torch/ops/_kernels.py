"""Build and load the port's hand-written CUDA kernels.

Each kernel source `frenetix_tpu_torch/csrc/<name>.cu` is compiled by `nvcc`
for Hopper (`sm_90a`) into a shared library with a plain C interface and
loaded with `ctypes`.  The build happens at first use, never at import, into
`build/torch_kernels/` at the repository root.  The library file is named by
a hash of the sources and the flags, so a stale build is never loaded.

Clear the cache with `rm -rf build/torch_kernels`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "load_library", "build_info"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# --fmad=false: no FMA contraction, so each kernel agrees bitwise with its
# plain PyTorch twin on the card.  -Xptxas -v reports registers and spills.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libraries: dict[str, ctypes.CDLL] = {}
_build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels of frenetix_tpu_torch are built at first use and need "
        "the CUDA toolkit"
    )


def _library_path(name: str) -> tuple[Path, Path]:
    source = CSRC_DIR / f"{name}.cu"
    if not source.exists():
        raise FileNotFoundError(f"kernel source {source} does not exist")
    digest = hashlib.sha256()
    digest.update("\0".join(NVCC_FLAGS).encode())
    for path in [source, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return source, BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, compiling it first if needed.

    Raises RuntimeError with the compiler's stderr if `nvcc` is missing or
    the build fails."""
    lib = _libraries.get(name)
    if lib is not None:
        return lib
    source, target = _library_path(name)
    info = {"library": str(target), "built": False, "seconds": 0.0, "log": ""}
    if not target.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = target.with_name(f"{target.stem}.{os.getpid()}.partial.so")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(partial), str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            partial.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {source.name} "
                f"(exit {proc.returncode}):\n{proc.stderr}"
            )
        os.replace(partial, target)
        info.update(built=True, seconds=time.perf_counter() - t0,
                    log=proc.stderr)
    lib = ctypes.CDLL(str(target))
    _libraries[name] = lib
    _build_info[name] = info
    return lib


def build_info(name: str) -> dict:
    """What `load_library(name)` did: library path, whether it compiled,
    the compile seconds and the compiler's log (ptxas register report)."""
    return dict(_build_info[name])
