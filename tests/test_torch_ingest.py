"""The port's ingest modules vs the JAX reference (CPU).

Modules: data/rosbag.py and data/lz4f.py (copies of the reference's host
modules), data/native_store.pair_stamps / rgb_to_gray (the C entries of
native/src/vostore.cpp), data/sequence.pair_timestamps /
build_paired_sequence, and eval/plots.py (a copy). Bags are synthesized by
tests/torch_bag_data.py from a seeded sequence; every array is held equal
to the reference's on the same file (the readers are the same host code, so
exactly).
"""

import bz2
import inspect

import numpy as np
import pytest

from droplet_visual_odometry_tpu.core.camera import make_camera as jmake_camera
from droplet_visual_odometry_tpu.data import lz4f as jlz4f
from droplet_visual_odometry_tpu.data import native_store as jstore
from droplet_visual_odometry_tpu.data import rosbag as jrosbag
from droplet_visual_odometry_tpu.data import sequence as jsequence
from droplet_visual_odometry_tpu.eval import plots as jplots

from droplet_visual_odometry_tpu_torch.core.camera import make_camera as tmake_camera
from droplet_visual_odometry_tpu_torch.data import lz4f as tlz4f
from droplet_visual_odometry_tpu_torch.data import native_store as tstore
from droplet_visual_odometry_tpu_torch.data import rosbag as trosbag
from droplet_visual_odometry_tpu_torch.data import sequence as tsequence
from droplet_visual_odometry_tpu_torch.data import synthetic as tsynth
from droplet_visual_odometry_tpu_torch.eval import plots as tplots

import torch_bag_data as bags

ENCODINGS = ["mono8", "mono8", "rgb8", "mono8", "bgr8", "mono8", "mono8", "rgb8"]


@pytest.fixture(scope="module")
def seq():
    s = tsynth.render_sequence(tsynth.SyntheticConfig(n_frames=8, width=96, height=72, n_landmarks=60))
    s.marker_present[3:5] = False
    s.marker_corners[3:5] = np.nan
    return s


def _assert_extracted_equal(got, want):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)  # NaN == NaN here
            assert g[k].dtype == w[k].dtype, k


# --------------------------------------------------------------------------
# data/rosbag.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("images", ["raw", "compressed"])
@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_extract_bag_equals_reference(seq, tmp_path, compression, images):
    """Raw images mix mono8, rgb8 and bgr8 frames; compressed ones are PNGs
    decoded by cv2. Frames, stamps and every detection array equal the
    reference's exactly; the frames are the sequence's (rgb frames: their
    BT.601 luma), the stamps the stored nanosecond stamps, and the absent
    frames carry the decoy id."""
    path = str(tmp_path / "t.bag")
    encodings = None if images == "compressed" else ENCODINGS
    bags.sequence_bag(path, seq, compression, encodings=encodings, compressed=images == "compressed")
    got = trosbag.extract_bag(path, bags.IMG_TOPIC, bags.MARKER_TOPIC)
    want = jrosbag.extract_bag(path, bags.IMG_TOPIC, bags.MARKER_TOPIC)
    _assert_extracted_equal(got, want)
    frames, dets = got
    np.testing.assert_array_equal(frames["frames"], bags.expected_frames(seq, encodings))
    np.testing.assert_array_equal(frames["timestamps"], bags.stored_stamps(seq.timestamps))
    np.testing.assert_array_equal(dets["ids"][:, 0], np.where(seq.marker_present, 0, 7))
    assert (dets["ids"][:, 1:] == -1).all()
    present = seq.marker_present
    np.testing.assert_array_equal(dets["corners"][present, 0], seq.marker_corners[present])
    assert np.isnan(dets["corners"][~present]).all()


def test_extract_bag_several_markers_and_empty_messages(tmp_path):
    """A message with more markers than max_markers (the rest dropped), one
    with none (dropped, as the reference's reader drops empty messages),
    random ids, poses and corners: equal to the reference."""
    rng = np.random.default_rng(3)
    conns = [bags.connection_record(0, bags.IMG_TOPIC, "sensor_msgs/Image", bags.RAW_IMAGE_DEF),
             bags.connection_record(1, bags.MARKER_TOPIC, "stag_ros/StagMarkers", bags.MARKERS_DEF)]

    def marker(mid):
        return (mid, rng.uniform(0, 50, (4, 2)), rng.normal(size=3), rng.normal(size=4))

    msgs = []
    for i, n_markers in enumerate([6, 0, 2, 1]):
        t = 100.0 + 0.25 * i
        msgs.append((0, t, bags.raw_image_msg(t, rng.integers(0, 255, (12, 16), dtype=np.uint8))))
        msgs.append((1, t, bags.markers_msg(t, [marker(int(m)) for m in rng.integers(0, 9, n_markers)])))
    path = str(tmp_path / "m.bag")
    bags.write_bag(path, conns, msgs, "bz2")
    got = trosbag.extract_bag(path, bags.IMG_TOPIC, bags.MARKER_TOPIC, max_markers=4)
    _assert_extracted_equal(got, jrosbag.extract_bag(path, bags.IMG_TOPIC, bags.MARKER_TOPIC, max_markers=4))
    assert got[1]["ids"].shape == (3, 4) and (got[1]["ids"][1, 2:] == -1).all()


def test_reader_parses_definitions_as_reference():
    parsed = trosbag.parse_definition("stag_ros/StagMarkers", bags.MARKERS_DEF)
    assert parsed == jrosbag.parse_definition("stag_ros/StagMarkers", bags.MARKERS_DEF)
    assert parsed["stag_ros/StagMarker"][2] == ("uint8", "reprojection_error")


def test_reader_rejects_non_bag(tmp_path):
    p = tmp_path / "x.bag"
    p.write_bytes(b"PK\x03\x04 definitely not a bag\n")
    with pytest.raises(ValueError, match="not a ROS bag"):
        trosbag.BagReader(str(p))


def test_decompress_all_codecs_as_reference():
    payload = bytes(np.random.default_rng(1).integers(0, 8, 200_000, dtype=np.uint8))
    for codec, data in ((b"none", payload), (b"bz2", bz2.compress(payload)), (b"lz4", tlz4f.compress_frame(payload))):
        assert bytes(trosbag._decompress(codec, memoryview(data))) == payload
        assert bytes(jrosbag._decompress(codec, memoryview(data))) == payload
    with pytest.raises(NotImplementedError):
        trosbag._decompress(b"zstd", memoryview(payload))


# --------------------------------------------------------------------------
# data/lz4f.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("payload", ["compressible", "incompressible", "empty", "repeats"])
def test_lz4_decoders_equal_and_equal_reference(monkeypatch, payload):
    """liblz4's block decoder and the pure-Python one decode the same
    liblz4-made frames byte for byte, equal to the reference's decoder:
    block-linked frames whose matches reach into the previous block
    (> 64 KB), and incompressible blocks stored raw."""
    assert tlz4f.native_available()
    rng = np.random.default_rng(0)
    data = {
        "compressible": bytes(rng.integers(0, 4, 300_000, dtype=np.uint8)),
        "incompressible": bytes(rng.integers(0, 256, 5_000, dtype=np.uint8)),
        "empty": b"",
        "repeats": b"abc" * 50_000,
    }[payload]
    frame = tlz4f.compress_frame(data)
    assert frame == jlz4f.compress_frame(data)
    assert tlz4f.decompress(frame) == data == jlz4f.decompress(frame)
    monkeypatch.setattr(tlz4f, "_lib", None)
    monkeypatch.setattr(tlz4f, "_lib_tried", True)
    assert tlz4f.decompress(frame) == data  # the pure-Python block decoder


def test_lz4_rejects_corrupt_frames():
    frame = tlz4f.compress_frame(b"xyz" * 1000)
    for bad, msg in ((b"\x00" * 8, "bad magic"), (frame[:5], "truncated"), (frame[:12], "truncated")):
        with pytest.raises(ValueError, match=msg):
            tlz4f.decompress(bad)


# --------------------------------------------------------------------------
# The copies against the reference's source
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mods", [(tlz4f, jlz4f), (trosbag, jrosbag), (tplots, jplots)],
                         ids=["lz4f", "rosbag", "plots"])
def test_copied_modules_match_reference_function_by_function(mods):
    """Every function and class of the reference module is in the copy with
    the same source, the package name aside (the copies are kept so, as
    importing the reference's imports jax)."""
    port, ref = mods
    names = [n for n, v in vars(ref).items()
             if (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == ref.__name__]
    assert names
    for name in names:
        want = inspect.getsource(getattr(ref, name)).replace("droplet_visual_odometry_tpu.", "droplet_visual_odometry_tpu_torch.")
        assert inspect.getsource(getattr(port, name)) == want, name


# --------------------------------------------------------------------------
# data/native_store.py helpers, data/sequence.py pairing
# --------------------------------------------------------------------------


def test_pair_stamps_equals_reference():
    rng = np.random.default_rng(5)
    a = np.sort(rng.choice(np.arange(0, 50) * 0.05, 30, replace=False))
    b = np.sort(np.concatenate([rng.choice(a, 12, replace=False), rng.uniform(0, 3, 9)]))
    ia, ib = tstore.pair_stamps(a, b)
    ja, jb = jstore.pair_stamps(a, b)
    np.testing.assert_array_equal(ia, ja)
    np.testing.assert_array_equal(ib, jb)
    assert ia.dtype == ib.dtype == np.int64 and len(ia) == 12
    np.testing.assert_array_equal(a[ia], b[ib])
    assert [len(x) for x in tstore.pair_stamps(a, np.asarray([]))] == [0, 0]


@pytest.mark.parametrize("order", ["rgb", "bgr"])
def test_rgb_to_gray_bit_for_bit(order):
    img = np.random.default_rng(2).integers(0, 256, (5, 37, 41, 3), dtype=np.uint8)
    got = tstore.rgb_to_gray(img, order=order)
    np.testing.assert_array_equal(got, jstore.rgb_to_gray(img, order=order))
    np.testing.assert_array_equal(got, bags.bt601_gray(img if order == "rgb" else img[..., ::-1]))
    with pytest.raises(ValueError):
        tstore.rgb_to_gray(img[..., :2])


def test_pair_timestamps_equals_reference():
    img = [0.0, 0.5, 1.0, 1.5, 2.0]
    mrk = np.asarray([2.0, 0.5, 3.0, 1.0])
    got = tsequence.pair_timestamps(img, mrk)
    np.testing.assert_array_equal(got, jsequence.pair_timestamps(img, mrk))
    np.testing.assert_array_equal(got, [0.5, 1.0, 2.0])


def test_build_paired_sequence_equals_reference():
    rng = np.random.default_rng(4)
    img_stamps = np.arange(6) / 10
    frames = rng.integers(0, 255, (6, 12, 16), dtype=np.uint8)
    mrk_stamps = np.asarray([0.1, 0.2, 0.3, 0.5, 0.7])
    ids = np.asarray([3, -1, 3, 3, 3], np.int32)  # the empty message at 0.2 is dropped
    corners = rng.uniform(0, 10, (5, 4, 2))
    poses = np.tile(np.eye(4), (5, 1, 1)) + rng.normal(scale=0.1, size=(5, 4, 4))
    args = (img_stamps, frames, mrk_stamps, corners, poses, ids)
    got = tsequence.build_paired_sequence(*args, tmake_camera(20, 20, 8, 6, None, 16, 12), 0.2)
    want = jsequence.build_paired_sequence(*args, jmake_camera(20, 20, 8, 6, None, 16, 12), 0.2)
    for f in ("frames", "timestamps", "marker_corners", "marker_poses", "marker_present", "marker_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    np.testing.assert_array_equal(got.timestamps, [0.1, 0.3, 0.5])
    got.validate()
