"""Pure-Python ROS1 bag reader — the ingest bridge from recorded `.bag` files
to the VOSequence npz schema, with NO ROS installation.

A copy of droplet_visual_odometry_tpu/data/rosbag.py with the port's imports
(its lz4f copy and native_store.rgb_to_gray), kept function for function
equal to it. The reference docstring follows.

The reference reads bags through the `rosbag` ROS package
(get_valid_message_stream.py:25-29, trajectory_evaluation_dual_process.py) on
a ROS machine; this module implements the bag v2.0 container format
(http://wiki.ros.org/Bags/Format/2.0) and a *generic* ROS1 message
deserializer driven by each connection's embedded `message_definition` text —
so custom types like the STag marker messages decode without their .msg
packages installed. Messages come back as plain nested dicts/numpy arrays.

Container format essentials:
  * magic line `#ROSBAG V2.0\n`, then a stream of records;
  * record = u32 header_len, header (u32-length-prefixed `name=value` fields),
    u32 data_len, data;
  * record kinds by the `op` header byte: 0x03 bag header, 0x07 connection
    (data = the connection header: topic/type/md5sum/message_definition),
    0x05 chunk (`compression` none|bz2|lz4; data = nested connection/message
    records), 0x02 message data (conn id + time; data = the serialized
    message), 0x04 index data / 0x06 chunk info (skipped).

Serialization: little-endian primitives; strings/arrays u32-length-prefixed;
`time`/`duration` are two u32s; fixed arrays `T[N]` have no length prefix.
"""

from __future__ import annotations

import bz2
import os
import struct
from typing import Iterator

import numpy as np

_OP_MSG = 0x02
_OP_BAG_HEADER = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNK_INFO = 0x06
_OP_CONNECTION = 0x07

_U32 = struct.Struct("<I")

# builtin type -> (struct fmt, numpy dtype) ; string/time/duration special-cased
_PRIMITIVES = {
    "bool": ("?", np.bool_),
    "int8": ("b", np.int8),
    "uint8": ("B", np.uint8),
    "byte": ("b", np.int8),
    "char": ("B", np.uint8),
    "int16": ("h", np.int16),
    "uint16": ("H", np.uint16),
    "int32": ("i", np.int32),
    "uint32": ("I", np.uint32),
    "int64": ("q", np.int64),
    "uint64": ("Q", np.uint64),
    "float32": ("f", np.float32),
    "float64": ("d", np.float64),
}


def _read_header(buf: memoryview, off: int, end: int) -> dict[bytes, bytes]:
    """Parse `name=value` fields of a record header in buf[off:end]."""
    fields: dict[bytes, bytes] = {}
    while off < end:
        (flen,) = _U32.unpack_from(buf, off)
        off += 4
        field = bytes(buf[off : off + flen])
        off += flen
        eq = field.index(b"=")
        fields[field[:eq]] = field[eq + 1 :]
    return fields


def _iter_records(buf: memoryview, off: int = 0) -> Iterator[tuple[dict, memoryview]]:
    """Yield (header_fields, data) for each record in buf[off:]."""
    n = len(buf)
    while off + 8 <= n:
        (hlen,) = _U32.unpack_from(buf, off)
        off += 4
        header = _read_header(buf, off, off + hlen)
        off += hlen
        (dlen,) = _U32.unpack_from(buf, off)
        off += 4
        yield header, buf[off : off + dlen]
        off += dlen


# --------------------------------------------------------------------------
# Generic message deserialization from message_definition text.
# --------------------------------------------------------------------------


def parse_definition(main_type: str, definition: str) -> dict[str, list[tuple[str, str]]]:
    """message_definition text -> {full_type: [(field_type, field_name), ...]}.

    The text is the main type's .msg source followed by every dependent type,
    each introduced by a `MSG: pkg/Type` line after a separator of '='s
    (gendeps --cat output, what rosbag record embeds per connection).
    Constants (`uint8 X=1`) are skipped; comments stripped.
    """
    types: dict[str, list[tuple[str, str]]] = {}
    cur_name = main_type
    cur_fields: list[tuple[str, str]] = []
    for raw in definition.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("==="):
            types[cur_name] = cur_fields
            cur_name, cur_fields = "", []
            continue
        if line.startswith("MSG:"):
            cur_name = line[4:].strip()
            continue
        parts = line.split(None, 1)
        if len(parts) != 2:
            continue
        ftype, fname = parts
        if "=" in fname:  # constant declaration
            continue
        cur_fields.append((ftype, fname.strip()))
    types[cur_name] = cur_fields
    return types


def _resolve(ftype: str, owner_pkg: str, types: dict) -> str:
    """Resolve a possibly package-relative field type to a key in `types`."""
    base = ftype.split("[", 1)[0]
    if base in _PRIMITIVES or base in ("string", "time", "duration"):
        return base
    if base == "Header":
        return "std_msgs/Header"
    if base in types:
        return base
    if "/" not in base:
        qualified = f"{owner_pkg}/{base}"
        if qualified in types:
            return qualified
    return base


class MessageType:
    """A deserializer for one ROS1 message type, built from its embedded
    definition. decode() returns nested dicts; primitive arrays come back as
    numpy arrays (uint8[] data fields stay raw bytes-backed arrays)."""

    def __init__(self, full_type: str, definition: str):
        self.full_type = full_type
        self.types = parse_definition(full_type, definition)
        if "std_msgs/Header" not in self.types:
            self.types["std_msgs/Header"] = [
                ("uint32", "seq"),
                ("time", "stamp"),
                ("string", "frame_id"),
            ]

    def decode(self, data: bytes | memoryview):
        view = memoryview(data)
        value, off = self._decode_type(self.full_type, view, 0)
        return value

    # -- internals --

    def _decode_type(self, full_type: str, buf: memoryview, off: int):
        pkg = full_type.split("/", 1)[0] if "/" in full_type else ""
        out: dict[str, object] = {}
        for ftype, fname in self.types[full_type]:
            out[fname], off = self._decode_field(ftype, pkg, buf, off)
        return out, off

    def _decode_field(self, ftype: str, pkg: str, buf: memoryview, off: int):
        if "[" in ftype:
            base, dims = ftype.split("[", 1)
            count = dims[:-1]
            if count == "":
                (n,) = _U32.unpack_from(buf, off)
                off += 4
            else:
                n = int(count)
            return self._decode_array(base, pkg, n, buf, off)
        base = _resolve(ftype, pkg, self.types)
        if base in _PRIMITIVES:
            fmt, _ = _PRIMITIVES[base]
            s = struct.Struct("<" + fmt)
            (v,) = s.unpack_from(buf, off)
            return v, off + s.size
        if base == "string":
            (n,) = _U32.unpack_from(buf, off)
            off += 4
            return bytes(buf[off : off + n]).decode("utf-8", "replace"), off + n
        if base in ("time", "duration"):
            secs, nsecs = struct.unpack_from("<II", buf, off)
            return secs + nsecs * 1e-9, off + 8
        return self._decode_type(base, buf, off)

    def _decode_array(self, base: str, pkg: str, n: int, buf: memoryview, off: int):
        rbase = _resolve(base, pkg, self.types)
        if rbase in _PRIMITIVES:
            _, dt = _PRIMITIVES[rbase]
            nbytes = n * np.dtype(dt).itemsize
            arr = np.frombuffer(buf, dtype=np.dtype(dt).newbyteorder("<"), count=n, offset=off)
            return arr, off + nbytes
        out = []
        for _ in range(n):
            v, off = self._decode_field(base, pkg, buf, off)
            out.append(v)
        return out, off


# --------------------------------------------------------------------------
# Bag reading.
# --------------------------------------------------------------------------


class Connection:
    def __init__(self, conn_id: int, topic: str, data: memoryview):
        fields = _read_header(data, 0, len(data))
        self.id = conn_id
        self.topic = fields.get(b"topic", topic.encode()).decode()
        self.type = fields[b"type"].decode()
        self.md5sum = fields.get(b"md5sum", b"").decode()
        self.message_type = MessageType(
            self.type, fields.get(b"message_definition", b"").decode()
        )


def _decompress(compression: bytes, data: memoryview) -> memoryview:
    if compression in (b"none", b""):
        return data
    if compression == b"bz2":
        return memoryview(bz2.decompress(data))
    if compression == b"lz4":
        try:
            import lz4.frame  # fastest path when the wheel happens to exist
            return memoryview(lz4.frame.decompress(bytes(data)))
        except ImportError:
            pass
        # In-repo LZ4 frame decoder (system liblz4 blocks when present,
        # pure-Python fallback) — all three rosbag compressions are readable
        # without any extra install (get_valid_message_stream.py:25-29 parity).
        from droplet_visual_odometry_tpu_torch.data import lz4f

        return memoryview(lz4f.decompress(bytes(data)))
    raise NotImplementedError(f"unknown chunk compression: {compression!r}")


class BagReader:
    """Sequential reader over a ROS1 v2.0 (or chunkless v1.2-style) bag.

    read_messages(topics) yields (topic, message_dict, record_time_sec) in
    file order — the same contract the reference relies on from
    rosbag.Bag.read_messages (get_valid_message_stream.py:29)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._raw = f.read()
        magic_end = self._raw.index(b"\n") + 1
        magic = self._raw[:magic_end]
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"not a ROS bag v2.0 file: {path} (magic {magic!r})")
        self._body = memoryview(self._raw)[magic_end:]
        self.connections: dict[int, Connection] = {}

    def _handle_connection(self, header: dict, data: memoryview) -> None:
        conn_id = _U32.unpack(header[b"conn"])[0]
        if conn_id not in self.connections:
            self.connections[conn_id] = Connection(
                conn_id, header.get(b"topic", b"").decode(), data
            )

    def read_messages(
        self, topics: list[str] | None = None
    ) -> Iterator[tuple[str, dict, float]]:
        want = set(topics) if topics is not None else None

        def emit(header: dict, data: memoryview):
            conn_id = _U32.unpack(header[b"conn"])[0]
            conn = self.connections.get(conn_id)
            if conn is None or (want is not None and conn.topic not in want):
                return None
            secs, nsecs = struct.unpack("<II", header[b"time"])
            return conn.topic, conn.message_type.decode(data), secs + nsecs * 1e-9

        for header, data in _iter_records(self._body):
            op = header.get(b"op", b"\x00")[0]
            if op == _OP_CONNECTION:
                self._handle_connection(header, data)
            elif op == _OP_CHUNK:
                inner = _decompress(header.get(b"compression", b"none"), data)
                for h2, d2 in _iter_records(inner):
                    op2 = h2.get(b"op", b"\x00")[0]
                    if op2 == _OP_CONNECTION:
                        self._handle_connection(h2, d2)
                    elif op2 == _OP_MSG:
                        out = emit(h2, d2)
                        if out is not None:
                            yield out
            elif op == _OP_MSG:  # chunkless writer (v1.2-style layout)
                out = emit(header, data)
                if out is not None:
                    yield out
            # 0x03/0x04/0x06: bag header / index / chunk info — skipped.


# --------------------------------------------------------------------------
# Decoders for the two message families the pipeline ingests.
# --------------------------------------------------------------------------


def decode_compressed_image(msg: dict) -> np.ndarray:
    """sensor_msgs/CompressedImage -> (H, W) uint8 grayscale (the reference's
    np.frombuffer + cv.imdecode + cvtColor, visual_odometry_v3.py:127-132)."""
    data = np.asarray(msg["data"], np.uint8)
    try:
        import cv2

        img = cv2.imdecode(data, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise ValueError(f"cv2 cannot decode {msg.get('format')!r} image")
        return np.asarray(img, np.uint8)
    except ImportError:
        from io import BytesIO

        from PIL import Image  # pillow fallback when cv2 is absent

        img = np.asarray(Image.open(BytesIO(data.tobytes())).convert("L"))
        return img.astype(np.uint8)


def decode_raw_image(msg: dict) -> np.ndarray:
    """sensor_msgs/Image (mono8/rgb8/bgr8) -> (H, W) uint8 grayscale."""
    h, w = int(msg["height"]), int(msg["width"])
    enc = msg["encoding"]
    data = np.asarray(msg["data"], np.uint8)
    if enc == "mono8":
        return data.reshape(h, int(msg["step"]))[:, :w]
    if enc in ("rgb8", "bgr8"):
        from droplet_visual_odometry_tpu_torch.data.native_store import rgb_to_gray

        rgb = data.reshape(h, int(msg["step"]))[:, : 3 * w].reshape(h, w, 3)
        return rgb_to_gray(rgb, order="rgb" if enc == "rgb8" else "bgr")
    raise NotImplementedError(f"image encoding {enc!r}")


def marker_fields(marker: dict) -> tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """One STag/AR marker dict -> (id, corners (4,2), translation (3,), quat
    xyzw (4,)). Field access mirrors the reference's usage:
    marker.id / marker.corners[k].x/.y (traj_eval_ground_truth.py:207,264-268)
    and marker.pose.pose.position/orientation (gt:105-106); falls back to a
    plain `pose` (geometry_msgs/Pose) when there is no covariance wrapper."""
    mid = int(marker.get("id", 0))
    corners = np.asarray(
        [[float(c["x"]), float(c["y"])] for c in marker.get("corners", [])],
        np.float64,
    ).reshape(-1, 2)
    pose = marker.get("pose", {})
    while "pose" in pose:  # unwrap PoseWithCovariance(Stamped) layers
        pose = pose["pose"]
    pos = pose.get("position", {})
    ori = pose.get("orientation", {})
    t = np.asarray(
        [float(pos.get(a, np.nan)) for a in ("x", "y", "z")], np.float64
    )
    q = np.asarray(
        [float(ori.get(a, np.nan)) for a in ("x", "y", "z", "w")], np.float64
    )
    return mid, corners, t, q


def extract_bag(
    bag_path: str,
    image_topic: str,
    marker_topic: str,
    max_markers: int = 4,
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Read one bag -> (frames_dict, detections_dict) ready for np.savez.

    frames_dict:     frames (N, H, W) u8, timestamps (N,) f64
    detections_dict: the cli/convert detections schema — stamps (Nm,) f64,
                     ids (Nm, M) i32 (-1 empty), translations (Nm, M, 3),
                     quaternions (Nm, M, 4) xyzw, corners (Nm, M, 4, 2).

    Timestamps are HEADER stamps (bag-record time is arrival time; the
    reference pairs on header.stamp, get_valid_message_stream.py:33-36).
    """
    reader = BagReader(bag_path)
    frames: list[np.ndarray] = []
    f_stamps: list[float] = []
    det_rows: list[tuple[float, list]] = []

    for topic, msg, t in reader.read_messages([image_topic, marker_topic]):
        stamp = float(msg.get("header", {}).get("stamp", t))
        if topic == image_topic:
            if "encoding" in msg:
                frames.append(decode_raw_image(msg))
            else:
                frames.append(decode_compressed_image(msg))
            f_stamps.append(stamp)
        else:
            markers = msg.get("markers", [])
            if len(markers) > 0:  # reference drops empty marker msgs (gvms:35-36)
                det_rows.append((stamp, markers))

    if not frames:
        raise ValueError(f"no messages on image topic {image_topic!r}")
    frames_np = np.stack(frames)
    nm, m = len(det_rows), max_markers
    ids = np.full((nm, m), -1, np.int32)
    trans = np.full((nm, m, 3), np.nan, np.float64)
    quats = np.full((nm, m, 4), np.nan, np.float64)
    corners = np.full((nm, m, 4, 2), np.nan, np.float64)
    d_stamps = np.empty(nm, np.float64)
    for i, (stamp, markers) in enumerate(det_rows):
        d_stamps[i] = stamp
        for j, marker in enumerate(markers[:m]):
            mid, cs, tv, qv = marker_fields(marker)
            ids[i, j] = mid
            trans[i, j] = tv
            quats[i, j] = qv
            if cs.shape[0] >= 4:
                corners[i, j] = cs[:4]
    return (
        {"frames": frames_np, "timestamps": np.asarray(f_stamps, np.float64)},
        {
            "stamps": d_stamps,
            "ids": ids,
            "translations": trans,
            "quaternions": quats,
            "corners": corners,
        },
    )
