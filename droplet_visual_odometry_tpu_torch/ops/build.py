"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The kernels are compiled from this package's own sources at first use for
sm_90a, one `nvcc` process per source, all started together, then linked
into one library in `droplet_visual_odometry_tpu_torch/_build/`
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# Seconds the last build in this process took (0.0 when the library was
# already on disk), and ptxas's report of each kernel's registers, shared
# memory and spills from that build ("" when none ran); chip_smoke.py prints both.
last_build_seconds = 0.0
last_ptxas_report = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double

# C entry points and their argument types; every pointer and the stream are
# c_void_p (a bare Python int would be passed as a 32-bit int and cut).
_SIGNATURES = {
    "dvo_fast_score": [_P, _P, _I, _I, _I, _F, _I, _P],
    "dvo_orb_describe": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "dvo_match_reductions": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "dvo_pose_graph_pcg": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _F, _I, _I, _P],
    "dvo_windowed_ba": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _D, _D, _D, _D, _I, _I, _P],
    "dvo_l2_match_reductions": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
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


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise with the output of any that failed,
    else return their combined standard error."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in cmds]
    failed, errs = [], []
    for cmd, proc in zip(cmds, procs):
        stdout, stderr = proc.communicate()
        errs.append(stderr)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(errs)


def build() -> str:
    """Compile csrc/*.cu into _build/ unless the keyed library exists; return its path."""
    global last_build_seconds, last_ptxas_report
    srcs = sources()
    key = _digest(srcs)
    out = os.path.join(BUILD_DIR, f"libdvo_kernels_{key}.so")
    if os.path.exists(out):
        last_build_seconds = 0.0
        last_ptxas_report = ""
        return out
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{key}.{os.getpid()}.o") for s in srcs]
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas=-v", "-c", "-o", o, s] for s, o in zip(srcs, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            if os.path.exists(f):
                os.remove(f)
    last_build_seconds = time.perf_counter() - t0
    last_ptxas_report = "\n".join(
        l.strip() for l in log.splitlines() if l.startswith("ptxas info") or "spill" in l
    )
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
