"""Sequence conversion CLI — recorded data -> VOSequence (.npz) / VOSTORE1 —
port of droplet_visual_odometry_tpu/cli/convert.py, with the same sources
and flags, plus --platform: where the ground truth is derived (the card
unless `--platform cpu`).

Sources, none of which needs ROS:
  * --images: a directory of frames (jpg/png through OpenCV, or .npy) and a
    detections .npz;
  * --raw: one .npz with frames and timestamps, and a detections .npz;
  * --bag: a recorded ROS1 `.bag`, read by the pure-Python reader
    (data/rosbag.py) from its image and marker topics.

Pairing: empty marker messages are dropped, then image and marker streams
are intersected on exactly equal timestamps by the native merge-join.

Detections npz schema (M = max markers per message):
  stamps (Nm,) f64 · ids (Nm, M) i32 (-1 empty) · translations (Nm, M, 3)
  quaternions (Nm, M, 4) xyzw · corners (Nm, M, 4, 2)

Usage:
  python -m droplet_visual_odometry_tpu_torch.cli.convert \\
      --bag run.bag --calibration cam.yaml \\
      --marker-id 0 --marker-length 0.2 --out seq.npz [--vostore seq.vostore]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Load one grayscale frame: .npy directly; else OpenCV decode."""
    if path.endswith(".npy"):
        img = np.load(path)
    else:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise OSError(f"cannot decode image: {path}")
    if img.ndim == 3:
        from droplet_visual_odometry_tpu_torch.data.native_store import rgb_to_gray

        img = rgb_to_gray(img, order="bgr")
    return np.asarray(img, np.uint8)


def frames_from_folder(folder: str, stamps_from_names: bool) -> tuple[np.ndarray, np.ndarray]:
    names = sorted(
        f for f in os.listdir(folder) if f.lower().endswith((".jpg", ".jpeg", ".png", ".npy"))
    )
    if not names:
        raise SystemExit(f"no frames in {folder}")
    frames = np.stack([load_image(os.path.join(folder, f)) for f in names])
    if stamps_from_names:
        stamps = np.asarray([float(os.path.splitext(f)[0]) for f in names], np.float64)
    else:
        stamps = np.arange(len(names), dtype=np.float64)
    return frames, stamps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--images", help="directory of frame images (.jpg/.png/.npy)")
    src.add_argument("--raw", help=".npz with frames (N,H,W) u8 + timestamps (N,) f64")
    src.add_argument("--bag", help="ROS1 .bag file (read without ROS, data/rosbag.py)")
    p.add_argument("--image-topic", default="/camera_array/cam1/image_raw/compressed",
                   help="bag image topic (the reference's default)")
    p.add_argument("--marker-topic", default="/stag_markers",
                   help="bag marker-detections topic")
    p.add_argument("--stamps-from-names", action="store_true",
                   help="parse frame timestamps from file names (e.g. 1690312345.123456.jpg)")
    p.add_argument("--detections", default=None,
                   help="marker detections .npz (see module docstring); "
                   "required unless --bag (bags carry the marker topic)")
    p.add_argument("--calibration", required=True, help="camera yaml (the reference's schemas)")
    p.add_argument("--controlled", action="store_true", help="calibration schema switch")
    p.add_argument("--marker-id", type=int, required=True)
    p.add_argument("--marker-length", type=float, required=True)
    p.add_argument("--camera-frame-detections", action="store_true",
                   help="detections are already camera-frame (skip cTb extrinsics)")
    p.add_argument("--out", required=True, help="output VOSequence .npz")
    p.add_argument("--vostore", default=None, help="also write a native vostore file")
    p.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                   help="where the ground truth is derived: the card unless 'cpu'")
    args = p.parse_args(argv)
    if not args.bag and not args.detections:
        p.error("--detections is required unless reading a --bag")

    from droplet_visual_odometry_tpu_torch import groundtruth as gt
    from droplet_visual_odometry_tpu_torch.core.camera import load_calibration
    from droplet_visual_odometry_tpu_torch.data import sequence as seq_mod
    from droplet_visual_odometry_tpu_torch.data.native_store import pair_stamps, write_store
    from droplet_visual_odometry_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.platform or "cuda")  # before the read: no card, no work
    if args.bag:
        from droplet_visual_odometry_tpu_torch.data.rosbag import extract_bag

        frames_d, dets_raw = extract_bag(args.bag, args.image_topic, args.marker_topic)
        frames = frames_d["frames"]
        img_stamps = frames_d["timestamps"]
        det_stamps = dets_raw.pop("stamps")
        dets_all = dict(
            ids=np.asarray(dets_raw["ids"], np.int32),
            translations=np.asarray(dets_raw["translations"], np.float32),
            quaternions=np.asarray(dets_raw["quaternions"], np.float32),
            corners=np.asarray(dets_raw["corners"], np.float32),
        )
    else:
        if args.images:
            frames, img_stamps = frames_from_folder(args.images, args.stamps_from_names)
        else:
            with np.load(args.raw) as z:
                frames = np.asarray(z["frames"], np.uint8)
                img_stamps = np.asarray(z["timestamps"], np.float64)

        with np.load(args.detections) as z:
            det_stamps = np.asarray(z["stamps"], np.float64)
            dets_all = dict(
                ids=np.asarray(z["ids"], np.int32),
                translations=np.asarray(z["translations"], np.float32),
                quaternions=np.asarray(z["quaternions"], np.float32),
                corners=np.asarray(z["corners"], np.float32),
            )

    # Drop empty marker messages (all ids < 0), then exact-stamp pair.
    nonempty = (dets_all["ids"] >= 0).any(axis=1)
    det_stamps = det_stamps[nonempty]
    dets_all = {k: v[nonempty] for k, v in dets_all.items()}
    ia, ib = pair_stamps(img_stamps, det_stamps)
    if len(ia) == 0:
        raise SystemExit("no exactly-matching timestamps between images and detections")

    cam = load_calibration(args.calibration, controlled=args.controlled)
    dets = gt.detections_from_arrays(
        dets_all["ids"][ib], dets_all["translations"][ib],
        dets_all["quaternions"][ib], dets_all["corners"][ib],
    )
    cfg = gt.GroundTruthConfig(use_base_link=not args.camera_frame_detections)
    seq = gt.sequence_from_detections(
        frames[ia], img_stamps[ia], dets, args.marker_id, cam, args.marker_length, cfg,
        device=device,
    )
    seq_mod.save(args.out, seq)
    print(f"wrote {args.out}: {len(seq)} paired frames "
          f"({int(np.sum(seq.marker_present))} with marker id {args.marker_id})")
    if args.vostore:
        write_store(args.vostore, seq.frames.astype(np.uint8), seq.timestamps)
        print(f"wrote {args.vostore}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
