"""A ROS1 bag v2.0 writer for the port's ingest tests and chip_smoke.py.

Imports no jax (chip_smoke.py and the card tests use it on the GPU machine).
It builds files per the public bag format (records, chunks with none / bz2 /
lz4 compression, connection headers with embedded message definitions,
little-endian message serialization), in the manner of
tests/test_rosbag.py's writer, and writes a VOSequence as a bag:

  * an image topic of sensor_msgs/Image (mono8, rgb8 or bgr8) or
    sensor_msgs/CompressedImage (PNG, lossless) messages;
  * a marker topic of STag-style messages (`id`, `corners`,
    `pose.pose.position/orientation`), decoded by the reader from their
    embedded definition alone. A frame whose reference marker is absent
    carries a decoy marker of another id with the frame's pose and no
    corners, so the message is not empty and the pose survives conversion.

The lz4 leg compresses with the system liblz4 (the port's data/lz4f.py
`compress_frame`), an independent compressor for the reader's decoder.
"""

from __future__ import annotations

import bz2
import struct

import numpy as np
import torch

IMG_TOPIC = "/camera_array/cam1/image_raw/compressed"
MARKER_TOPIC = "/stag_markers"
# Chunks close once they hold this many bytes (rosbag's default chunk size).
CHUNK_BYTES = 768 * 1024

_HEADER_DEF = """================================================================================
MSG: std_msgs/Header
uint32 seq
time stamp
string frame_id
"""

COMPRESSED_IMAGE_DEF = "Header header\nstring format\nuint8[] data\n\n" + _HEADER_DEF

RAW_IMAGE_DEF = (
    "Header header\nuint32 height\nuint32 width\nstring encoding\nuint8 is_bigendian\n"
    "uint32 step\nuint8[] data\n\n" + _HEADER_DEF
)

MARKERS_DEF = """Header header
StagMarker[] markers

""" + _HEADER_DEF + """================================================================================
MSG: stag_ros/StagMarker
Header header
uint32 id
uint8 reprojection_error   # an extra field: the reader must keep field order
geometry_msgs/PoseStamped pose
geometry_msgs/Point[] corners
================================================================================
MSG: geometry_msgs/PoseStamped
Header header
Pose pose
================================================================================
MSG: geometry_msgs/Pose
Point position
Quaternion orientation
================================================================================
MSG: geometry_msgs/Point
float64 x
float64 y
float64 z
================================================================================
MSG: geometry_msgs/Quaternion
float64 x
float64 y
float64 z
float64 w
"""


# -- records ------------------------------------------------------------------


def _field(name: bytes, value: bytes) -> bytes:
    body = name + b"=" + value
    return struct.pack("<I", len(body)) + body


def _record(fields: dict[bytes, bytes], data: bytes) -> bytes:
    header = b"".join(_field(k, v) for k, v in fields.items())
    return struct.pack("<I", len(header)) + header + struct.pack("<I", len(data)) + data


def stamp_parts(t: float) -> tuple[int, int]:
    """A time as the bag stores it: (u32 seconds, u32 nanoseconds)."""
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 1_000_000_000:
        secs, nsecs = secs + 1, nsecs - 1_000_000_000
    return secs, nsecs


def stored_stamps(stamps: np.ndarray) -> np.ndarray:
    """The stamps a reader gets back: secs + nsecs * 1e-9 of what is stored."""
    return np.asarray([s + n * 1e-9 for s, n in map(stamp_parts, np.asarray(stamps, np.float64))], np.float64)


def connection_record(conn_id: int, topic: str, msg_type: str, definition: str) -> bytes:
    inner = (
        _field(b"topic", topic.encode())
        + _field(b"type", msg_type.encode())
        + _field(b"md5sum", b"0" * 32)
        + _field(b"message_definition", definition.encode())
    )
    return _record({b"op": b"\x07", b"conn": struct.pack("<I", conn_id), b"topic": topic.encode()}, inner)


def message_record(conn_id: int, t: float, payload: bytes) -> bytes:
    return _record(
        {b"op": b"\x02", b"conn": struct.pack("<I", conn_id), b"time": struct.pack("<II", *stamp_parts(t))},
        payload,
    )


def chunk_record(records: bytes, compression: str) -> bytes:
    if compression == "bz2":
        data = bz2.compress(records)
    elif compression == "lz4":
        from droplet_visual_odometry_tpu_torch.data import lz4f

        data = lz4f.compress_frame(records)
    elif compression == "none":
        data = records
    else:
        raise ValueError(f"unknown compression {compression!r}")
    return _record(
        {b"op": b"\x05", b"compression": compression.encode(), b"size": struct.pack("<I", len(records))}, data
    )


def write_bag(path: str, connections: list[bytes], messages, compression: str = "none") -> None:
    """Write a bag: the connection records in the first chunk, then
    `messages` ((conn_id, stamp, payload) in time order), a chunk closed
    whenever it holds CHUNK_BYTES."""
    bag_header = _record(
        {
            b"op": b"\x03",
            b"index_pos": struct.pack("<Q", 0),
            b"conn_count": struct.pack("<I", len(connections)),
            b"chunk_count": struct.pack("<I", 0),
        },
        b" " * 128,  # real writers pad this record; the reader skips it
    )
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(bag_header)
        pending = [b"".join(connections)]
        size = len(pending[0])
        for conn_id, t, payload in messages:
            rec = message_record(conn_id, t, payload)
            pending.append(rec)
            size += len(rec)
            if size >= CHUNK_BYTES:
                f.write(chunk_record(b"".join(pending), compression))
                pending, size = [], 0
        if pending:
            f.write(chunk_record(b"".join(pending), compression))


# -- messages -----------------------------------------------------------------


def _string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def _header(t: float, frame_id: str = "cam", seq: int = 7) -> bytes:
    return struct.pack("<III", seq, *stamp_parts(t)) + _string(frame_id)


def raw_image_msg(t: float, img: np.ndarray, encoding: str = "mono8") -> bytes:
    """sensor_msgs/Image: (H, W) for mono8, (H, W, 3) for rgb8 / bgr8."""
    h, w = img.shape[:2]
    step = w * (1 if encoding == "mono8" else 3)
    data = np.ascontiguousarray(img, np.uint8).tobytes()
    return (_header(t) + struct.pack("<II", h, w) + _string(encoding) + struct.pack("<BI", 0, step)
            + struct.pack("<I", len(data)) + data)


def compressed_image_msg(t: float, img: np.ndarray) -> bytes:
    """sensor_msgs/CompressedImage holding a lossless PNG (needs cv2)."""
    import cv2

    ok, enc = cv2.imencode(".png", img)
    if not ok:
        raise RuntimeError("cv2.imencode failed")
    data = enc.tobytes()
    return _header(t) + _string("png") + struct.pack("<I", len(data)) + data


def markers_msg(t: float, markers) -> bytes:
    """A marker-array message; markers: (id, corners (C, 2), t (3,), q xyzw (4,))."""
    body = b""
    for mid, corners, tv, qv in markers:
        body += (
            _header(t)
            + struct.pack("<IB", int(mid), 0)
            + _header(t)  # PoseStamped.header
            + struct.pack("<ddd", *(float(v) for v in tv))
            + struct.pack("<dddd", *(float(v) for v in qv))
            + struct.pack("<I", len(corners))
            + b"".join(struct.pack("<ddd", float(c[0]), float(c[1]), 0.0) for c in corners)
        )
    return _header(t) + struct.pack("<I", len(markers)) + body


def pose_tq(cTm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, 4, 4) poses -> translations (N, 3) and xyzw quaternions (N, 4), float64."""
    from droplet_visual_odometry_tpu_torch.core import se3

    T = torch.as_tensor(np.asarray(cTm, np.float64))
    return T[:, :3, 3].numpy(), se3.rotmat_to_quat(T[:, :3, :3]).numpy()


def sequence_bag(
    path: str,
    seq,
    compression: str = "none",
    marker_id: int = 0,
    decoy_id: int = 7,
    encodings=None,
    compressed: bool = False,
) -> None:
    """Write a VOSequence as a bag: one image message and one marker message
    per frame at the frame's stamp. The marker message holds the reference
    marker (id `marker_id`, its four corners, the frame's cTm as t and q)
    where it is present, else a decoy (id `decoy_id`, no corners, the same
    pose). encodings: one of mono8 / rgb8 / bgr8 per frame (default mono8;
    colour frames come from `color_frame`); compressed=True
    writes PNG CompressedImage messages instead."""
    n = len(seq)
    tr, qs = pose_tq(seq.marker_poses)
    img_type, img_def = (("sensor_msgs/CompressedImage", COMPRESSED_IMAGE_DEF) if compressed
                         else ("sensor_msgs/Image", RAW_IMAGE_DEF))
    connections = [
        connection_record(0, IMG_TOPIC, img_type, img_def),
        connection_record(1, MARKER_TOPIC, "stag_ros/StagMarkers", MARKERS_DEF),
    ]
    encodings = encodings or ["mono8"] * n

    def messages():
        for i in range(n):
            t = float(seq.timestamps[i])
            if compressed:
                yield 0, t, compressed_image_msg(t, seq.frames[i])
            elif encodings[i] == "mono8":
                yield 0, t, raw_image_msg(t, seq.frames[i])
            else:
                rgb = color_frame(seq.frames[i], i)
                yield 0, t, raw_image_msg(t, rgb if encodings[i] == "rgb8" else rgb[..., ::-1], encodings[i])
            if seq.marker_present[i]:
                marker = (marker_id, seq.marker_corners[i], tr[i], qs[i])
            else:
                marker = (decoy_id, np.zeros((0, 2)), tr[i], qs[i])
            yield 1, t, markers_msg(t, [marker])

    write_bag(path, connections, messages(), compression)


def color_frame(gray: np.ndarray, i: int) -> np.ndarray:
    """A deterministic (H, W, 3) RGB frame made from a grey frame."""
    g = gray.astype(np.int32)
    return np.stack([g, (g * 3 + 17 * i) % 256, 255 - g], axis=-1).astype(np.uint8)


def bt601_gray(rgb: np.ndarray) -> np.ndarray:
    """OpenCV's fixed-point BT.601 luma of (..., 3) RGB uint8, in numpy."""
    x = rgb.astype(np.uint32)
    return ((9798 * x[..., 0] + 19235 * x[..., 1] + 3735 * x[..., 2] + (1 << 14)) >> 15).astype(np.uint8)


def expected_frames(seq, encodings=None) -> np.ndarray:
    """The grey frames a reader decodes from sequence_bag(seq, encodings=...)."""
    if not encodings:
        return np.asarray(seq.frames)
    return np.stack([f if e == "mono8" else bt601_gray(color_frame(f, i))
                     for i, (f, e) in enumerate(zip(seq.frames, encodings))])


CALIBRATION_YAML = "intrinsic_coeffs: [{K}]\ndistortion_coeffs: [{dist}]\nimage_width: {w}\nimage_height: {h}\n"


def write_calibration(path: str, camera) -> None:
    """The robot calibration schema (load_calibration(controlled=False)) of a camera."""
    with open(path, "w") as f:
        f.write(CALIBRATION_YAML.format(
            K=[float(v) for v in np.asarray(camera.K).reshape(-1)],
            dist=[float(v) for v in np.asarray(camera.dist).reshape(-1)],
            w=int(camera.width), h=int(camera.height),
        ))
