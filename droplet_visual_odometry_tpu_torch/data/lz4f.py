"""LZ4 frame decompression for rosbag chunks — no `lz4` wheel required.

A copy of droplet_visual_odometry_tpu/data/lz4f.py (host code that imports
no jax; importing it from the JAX package would import jax), kept function
for function equal to it. The reference docstring follows.

The reference reads bags through the rosbag C++ API, which supports chunk
compression none | bz2 | lz4 (get_valid_message_stream.py:25-29 just calls
`rosbag.Bag`; the lz4 leg is roslz4, writing standard LZ4 frames). This
module supplies the lz4 leg for data/rosbag.py:

  * frame parsing (magic 0x184D2204, FLG/BD descriptor, data blocks,
    EndMark, checksums skipped-not-verified) is implemented here from the
    LZ4 Frame Format spec v1.6.x;
  * block decompression uses the system `liblz4.so` via ctypes when present
    (LZ4_decompress_safe_usingDict, so block-LINKED frames — the liblz4
    default — decode correctly against the 64 KB history window), with a
    pure-Python LZ4 block decoder as the no-native fallback;
  * `compress_frame` binds liblz4's own LZ4F_compressFrame — used by the
    test-local bag writer so the lz4 read path is validated against a
    GENUINE independent compressor (the system liblz4), not a mirror of
    this module's own spec reading.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_MAGIC = 0x184D2204
_WINDOW = 65536  # LZ4 match window (64 KB)
_BLOCK_MAX = {4: 64 << 10, 5: 256 << 10, 6: 1 << 20, 7: 4 << 20}

_lib: ctypes.CDLL | None = None
_lib_tried = False


def _liblz4() -> ctypes.CDLL | None:
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    for name in ("liblz4.so.1", "liblz4.so", ctypes.util.find_library("lz4")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.LZ4_decompress_safe_usingDict.restype = ctypes.c_int
        lib.LZ4_decompress_safe_usingDict.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.LZ4F_compressFrameBound.restype = ctypes.c_size_t
        lib.LZ4F_compressFrameBound.argtypes = [ctypes.c_size_t, ctypes.c_void_p]
        lib.LZ4F_compressFrame.restype = ctypes.c_size_t
        lib.LZ4F_compressFrame.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p,
        ]
        lib.LZ4F_isError.restype = ctypes.c_uint
        lib.LZ4F_isError.argtypes = [ctypes.c_size_t]
        _lib = lib
        return _lib
    return None


def native_available() -> bool:
    return _liblz4() is not None


def _block_decompress_py(src: bytes, out: bytearray) -> None:
    """Decode one LZ4 block, appending to `out` (which carries the history
    window, so block-linked frames work). Raises ValueError on corruption."""
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise ValueError("lz4 block: literal run past end")
        out += src[i : i + lit]
        i += lit
        if i >= n:
            break  # last sequence: literals only
        off = src[i] | (src[i + 1] << 8)
        i += 2
        if off == 0:
            raise ValueError("lz4 block: zero match offset")
        mlen = token & 0xF
        if mlen == 15:
            while True:
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        start = len(out) - off
        if start < 0:
            raise ValueError("lz4 block: offset beyond window")
        if off >= mlen:
            out += out[start : start + mlen]
        else:  # overlapping match: byte-wise (RLE-style) copy
            for k in range(mlen):
                out.append(out[start + k])


def _block_decompress_native(
    lib: ctypes.CDLL, src: bytes, out: bytearray, dst_cap: int
) -> None:
    hist = bytes(out[-_WINDOW:])
    dst = ctypes.create_string_buffer(dst_cap)
    n = lib.LZ4_decompress_safe_usingDict(
        src, dst, len(src), dst_cap, hist, len(hist)
    )
    if n < 0:
        raise ValueError(f"liblz4: corrupt block (code {n})")
    out += dst.raw[:n]


def decompress(data: bytes) -> bytes:
    """Decompress one LZ4 frame (the payload rosbag lz4 chunks carry)."""
    mv = memoryview(data)
    if len(mv) < 7:
        raise ValueError("lz4 frame: truncated header")
    if int.from_bytes(mv[0:4], "little") != _MAGIC:
        raise ValueError("lz4 frame: bad magic")
    flg, bd = mv[4], mv[5]
    if (flg >> 6) & 0x3 != 1:
        raise ValueError(f"lz4 frame: unsupported version {(flg >> 6) & 0x3}")
    has_bchecksum = bool(flg & 0x10)
    has_csize = bool(flg & 0x08)
    has_cchecksum = bool(flg & 0x04)
    has_dictid = bool(flg & 0x01)
    bmax_code = (bd >> 4) & 0x7
    if bmax_code not in _BLOCK_MAX:
        raise ValueError(f"lz4 frame: bad block-max code {bmax_code}")
    dst_cap = _BLOCK_MAX[bmax_code]
    pos = 6
    if has_csize:
        pos += 8
    if has_dictid:
        pos += 4
    pos += 1  # header checksum byte (not verified)

    lib = _liblz4()
    out = bytearray()
    while True:
        if pos + 4 > len(mv):
            raise ValueError("lz4 frame: truncated block header")
        bsize = int.from_bytes(mv[pos : pos + 4], "little")
        pos += 4
        if bsize == 0:
            break  # EndMark
        uncompressed = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        if pos + bsize > len(mv):
            raise ValueError("lz4 frame: truncated block")
        block = bytes(mv[pos : pos + bsize])
        pos += bsize
        if uncompressed:
            out += block
        elif lib is not None:
            _block_decompress_native(lib, block, out, dst_cap)
        else:
            _block_decompress_py(block, out)
        if has_bchecksum:
            pos += 4  # xxh32, not verified
    if has_cchecksum:
        pos += 4
    return bytes(out)


def compress_frame(data: bytes) -> bytes:
    """Compress to one LZ4 frame with the SYSTEM liblz4 (LZ4F_compressFrame,
    default preferences: 64 KB block-linked). Test/fixture use: gives the
    reader a genuine independent compressor to validate against. Raises
    RuntimeError when liblz4 is unavailable."""
    lib = _liblz4()
    if lib is None:
        raise RuntimeError("liblz4 not available; cannot produce lz4 fixtures")
    bound = lib.LZ4F_compressFrameBound(len(data), None)
    dst = ctypes.create_string_buffer(bound)
    n = lib.LZ4F_compressFrame(dst, bound, data, len(data), None)
    if lib.LZ4F_isError(n):
        raise RuntimeError(f"LZ4F_compressFrame failed (code {n})")
    return dst.raw[:n]
