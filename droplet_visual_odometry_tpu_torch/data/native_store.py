"""The native frame store (VOSTORE1) — port of
droplet_visual_odometry_tpu/data/native_store.py: write_store, StoreReader
and StoreFrames, the host side of the chunked streaming path, and the two
ingest helpers pair_stamps and rgb_to_gray.

The library is the repository's C++ source native/src/vostore.cpp, built at
first use with the host C++ compiler into this package's `_build/`
(git-ignored), keyed by a hash of the source and flags: an mmap'd store, a
background prefetch ring and zero-copy chunk views. The file layout is the
reference's: the magic `VOSTORE1`, a 32-byte header (u64 frame count, u32
height, u32 width, 8 bytes zero), N float64 stamps, then N*H*W uint8 frames;
a file written by either package reads identically in the other.

There is no numpy fallback: without a compiler `native_available()` is
False and every entry point raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "src", "vostore.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")

_P = ctypes.c_void_p
_U64 = ctypes.c_uint64
_U32 = ctypes.c_uint32
_SIGNATURES = {  # name: (restype, argtypes)
    "vostore_write": (ctypes.c_int, [ctypes.c_char_p, _U64, _U32, _U32, _P, _P]),
    "vostore_open": (_P, [ctypes.c_char_p]),
    "vostore_info": (None, [_P, _P, _P, _P]),
    "vostore_timestamps": (None, [_P, _P]),
    "vostore_read": (ctypes.c_int, [_P, _U64, _U64, _P]),
    "vostore_prefetch_start": (ctypes.c_int, [_P, _U64, _U64]),
    "vostore_prefetch_next": (ctypes.c_int64, [_P, _P, _P]),
    "vostore_prefetch_acquire": (ctypes.c_int64, [_P, _P, _P]),
    "vostore_prefetch_release": (None, [_P]),
    "vostore_prefetch_stop": (None, [_P]),
    "vostore_close": (None, [_P]),
    "vostore_pair_stamps": (ctypes.c_int64, [_P, ctypes.c_int64, _P, ctypes.c_int64, _P, _P]),
    "vostore_rgb_to_gray": (None, [_P, _P, ctypes.c_int64, ctypes.c_int]),
}


def _compiler() -> str | None:
    return shutil.which("g++")


def _library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvostore_{h.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded store library, built on first call; raises with the
    compiler's output if there is no compiler or the build fails."""
    out = _library_path()
    if not os.path.exists(out):
        cxx = _compiler()
        if cxx is None:
            raise RuntimeError("no host C++ compiler (g++) on PATH: the native store cannot be built")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def native_available() -> bool:
    """True when the store library is built or a host compiler can build it
    (then it is built here)."""
    if not os.path.exists(_library_path()) and _compiler() is None:
        return False
    library()
    return True


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def write_store(path: str, frames: np.ndarray, timestamps: np.ndarray) -> None:
    """Write (N, H, W) uint8 frames + (N,) float64 stamps as a VOSTORE1 file."""
    frames = np.ascontiguousarray(frames, np.uint8)
    stamps = np.ascontiguousarray(timestamps, np.float64)
    n, h, w = frames.shape
    if stamps.shape != (n,):
        raise ValueError(f"write_store: {stamps.shape} stamps for {n} frames")
    if library().vostore_write(path.encode(), n, h, w, _ptr(frames), _ptr(stamps)) != 0:
        raise OSError(f"vostore_write failed: {path}")


class StoreReader:
    """Reader over a VOSTORE1 file through the native mmap reader."""

    def __init__(self, path: str):
        self.path = path
        self._lib = library()
        h = self._lib.vostore_open(path.encode())
        if not h:
            raise OSError(f"vostore_open failed: {path}")
        self._handle = ctypes.c_void_p(h)
        n, hh, ww = _U64(), _U32(), _U32()
        self._lib.vostore_info(self._handle, ctypes.byref(n), ctypes.byref(hh), ctypes.byref(ww))
        self.n, self.h, self.w = int(n.value), int(hh.value), int(ww.value)

    def timestamps(self) -> np.ndarray:
        out = np.empty(self.n, np.float64)
        self._lib.vostore_timestamps(self._handle, _ptr(out))
        return out

    def read(self, start: int, count: int) -> np.ndarray:
        if start < 0 or count < 0 or start + count > self.n:
            raise IndexError((start, count, self.n))
        out = np.empty((count, self.h, self.w), np.uint8)
        if self._lib.vostore_read(self._handle, start, count, _ptr(out)) != 0:
            raise OSError("vostore_read failed")
        return out

    def iter_chunks(self, chunk: int, nslots: int = 3, copy: bool = True):
        """Yield (start, frames) chunks read ahead by the background prefetch
        ring. copy=False yields read-only zero-copy views into the ring's
        slot, valid only until the next iteration (for consumers that forward
        the bytes at once, e.g. to a host-to-device copy)."""
        if self._lib.vostore_prefetch_start(self._handle, chunk, nslots) != 0:
            raise OSError("vostore_prefetch_start failed")
        start = _U64()
        try:
            if copy:
                buf = np.empty((chunk, self.h, self.w), np.uint8)
                while (got := self._lib.vostore_prefetch_next(self._handle, _ptr(buf), ctypes.byref(start))) > 0:
                    yield int(start.value), buf[:got].copy()
            else:
                ptr = ctypes.POINTER(ctypes.c_uint8)()
                while (got := self._lib.vostore_prefetch_acquire(self._handle, ctypes.byref(ptr),
                                                                 ctypes.byref(start))) > 0:
                    view = np.ctypeslib.as_array(ptr, shape=(got, self.h, self.w))
                    view.flags.writeable = False
                    yield int(start.value), view
                    self._lib.vostore_prefetch_release(self._handle)
            if got < 0:
                raise OSError("vostore prefetch failed")
        finally:
            self._lib.vostore_prefetch_stop(self._handle)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.vostore_close(self._handle)
            self._handle = None

    def frames(self) -> "StoreFrames":
        """Array-like (N, H, W) uint8 view that reads on demand: feed it to
        the streaming path (pipeline.run_experiment, utils.checkpoint)."""
        return StoreFrames(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StoreFrames:
    """ndarray-like facade over a StoreReader: `.shape`, `.dtype`, step-1
    slice reads and 1-D fancy-index reads; only the requested frames are
    read."""

    def __init__(self, reader: StoreReader):
        self._r = reader
        self.shape = (reader.n, reader.h, reader.w)
        self.dtype = np.dtype(np.uint8)

    def __len__(self) -> int:
        return self._r.n

    def __getitem__(self, key) -> np.ndarray:
        if isinstance(key, slice):
            start, stop, step = key.indices(self._r.n)
            if step != 1:
                raise IndexError("StoreFrames supports step-1 slices only")
            return self._r.read(start, max(stop - start, 0))
        idx = np.atleast_1d(np.asarray(key))
        if idx.ndim != 1:
            raise IndexError("StoreFrames supports 1-D fancy indexing only")
        out = np.empty((len(idx), self._r.h, self._r.w), np.uint8)
        for k, i in enumerate(idx):
            out[k] = self._r.read(int(i), 1)[0]
        return out


# ---------------------------------------------------------------------------
# host-side ingest helpers
# ---------------------------------------------------------------------------


def pair_stamps(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact-stamp pairing of two SORTED stamp arrays -> (idx_a, idx_b), a
    merge-join in C++ (duplicate stamps pair first with first)."""
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    ia = np.empty(min(len(a), len(b)), np.int64)
    ib = np.empty_like(ia)
    k = library().vostore_pair_stamps(_ptr(a), len(a), _ptr(b), len(b), _ptr(ia), _ptr(ib))
    return ia[:k].copy(), ib[:k].copy()


def rgb_to_gray(img: np.ndarray, order: str = "rgb") -> np.ndarray:
    """(..., 3) uint8 -> (...) uint8 BT.601 luma in OpenCV's 15-bit fixed
    point (cvtColor parity); order "rgb" or "bgr"."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.shape[-1] != 3:
        raise ValueError(f"rgb_to_gray: expected (..., 3) pixels, got {img.shape}")
    if order not in ("rgb", "bgr"):
        raise ValueError(f"rgb_to_gray: unknown channel order {order!r}")
    out = np.empty(img.shape[:-1], np.uint8)
    library().vostore_rgb_to_gray(_ptr(img), _ptr(out), out.size, 0 if order == "rgb" else 1)
    return out
