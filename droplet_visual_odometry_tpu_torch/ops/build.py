"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The kernels are compiled from this package's own sources at first use, with
one `nvcc` call for sm_90a, into `droplet_visual_odometry_tpu_torch/_build/`
(git-ignored). The library has a plain C interface and is loaded with
ctypes: no PyTorch headers are compiled, so a build takes seconds.

The file name carries a hash of the sources and flags, and the compiler
writes to a temporary name that is renamed into place, so concurrent
processes never load a half-written library. Importing this module never
builds anything; `library()` does, and raises with the compiler's output if
`nvcc` is missing or the build fails.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# Seconds the last build in this process took (0.0 when the library was
# already on disk); chip_smoke.py reports it.
last_build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points and their argument types; every pointer and the stream are
# c_void_p (a bare Python int would be passed as a 32-bit int and cut).
_SIGNATURES = {
    "dvo_fast_score": [_P, _P, _I, _I, _I, _F, _I, _P],
    "dvo_extract_patches": [_P, _P, _P, _I, _I, _I, _P],
    "dvo_match_reductions": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
}


def sources() -> list[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cu")
    )


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the port's CUDA kernels cannot be built"
    )


def _digest(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(os.path.basename(s).encode())
        with open(s, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile csrc/*.cu into _build/ unless the keyed library exists; return its path."""
    global last_build_seconds
    srcs = sources()
    out = os.path.join(BUILD_DIR, f"libdvo_kernels_{_digest(srcs)}.so")
    if os.path.exists(out):
        last_build_seconds = 0.0
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, *srcs], capture_output=True, text=True
    )
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    last_build_seconds = time.perf_counter() - t0
    return out


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error (cudaGetLastError())."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def current_stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
