"""End-to-end experiment pipeline — port of
droplet_visual_odometry_tpu/pipeline.py.

Take a paired sequence, undistort its frames on the device, run per-pair VO
seeded from the first marker pose, anchor, optionally refine the trajectory
(backend "pose_graph": loop closure and the pose graph; "ba": windowed
bundle adjustment), and emit ATE/RPE and the six TUM streams. Long sequences
stream: raw frames stay on the host and cross to the device one chunk at a
time (utils/checkpoint.py), and the backends fetch their keyframes the same
way. The entry points run on the card unless the caller asks for the CPU
(`device="cpu"`, as the tests do); `"cuda"` without a GPU raises.

Spans (utils/profiling): each `run_experiment` is one root,
`pipeline.run_experiment` (counts `frames`, `pairs`, `hypotheses`,
`matches`, `inliers` from the VO trajectory's host arrays), with the
children `pipeline.camera` (the undistortion map, the effective
intrinsics and marker corners), `pipeline.preprocess` (the upload and
remap of in-memory frames, with its device interval), `vo.run` (the VO
program, in memory or chunked), `vo.fetch` (the trajectory's host copy),
`pipeline.anchor` (ground truth and anchoring), the backend's span,
`pipeline.metrics` (inverses, ATE/RPE, the relative VO poses) and
`pipeline.tum` (the six TUM files).
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from droplet_visual_odometry_tpu_torch.backend.refine import (
    PoseGraphRefineConfig,
    RefineConfig,
    pose_graph_trajectory,
    refine_trajectory,
)
from droplet_visual_odometry_tpu_torch.core import camera as camera_mod
from droplet_visual_odometry_tpu_torch.core import se3
from droplet_visual_odometry_tpu_torch.data.sequence import VOSequence
from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig, VOTrajectory, run_sequence
from droplet_visual_odometry_tpu_torch.eval import metrics, tum
from droplet_visual_odometry_tpu_torch.utils.checkpoint import run_sequence_checkpointed
from droplet_visual_odometry_tpu_torch.utils import profiling, threefry
from droplet_visual_odometry_tpu_torch.utils.device import resolve_device

BACKENDS = ("none", "pose_graph", "ba")
# Sequences whose frames exceed this many bytes as float32 stream by default
# (346 frames at 1440x1080).
STREAM_BYTES = 2 << 30
# A streamed keyframe fetch stages its host gathers in two page-locked blocks
# of this many bytes of raw frames (43 frames of 1440x1080 uint8), each
# gathered by up to this many host threads (8 copy 25 GB/s into pinned pages
# on an H100 machine's host; one copies 5.5).
FETCH_BLOCK_BYTES = 64 << 20
GATHER_THREADS = 8


@dataclasses.dataclass
class ExperimentResult:
    timestamps: np.ndarray
    gt_abs: np.ndarray  # (N, 4, 4) cTm ground truth
    gt_rel: np.ndarray  # (N-1, 4, 4)
    vo_abs: np.ndarray  # (N, 4, 4)
    vo_rel: np.ndarray  # (N-1, 4, 4)
    trajectory: VOTrajectory  # fields as numpy arrays
    ate: metrics.ATEResult
    rpe: metrics.RPEResult
    stream_paths: dict[str, str] | None = None
    backend_info: dict | None = None


def make_preprocessor(seq: VOSequence, device="cuda"):
    """Chunk preprocessor: raw (C, H, W) uint8 frames (a host array-like or
    a tensor) -> (C, H, W) float32 undistorted frames on `device`. Frames
    cross to the device in their raw dtype; the cast and the bilinear remap
    run there."""
    dev = resolve_device(device)
    to_dev = lambda c: (c if isinstance(c, torch.Tensor) else torch.as_tensor(np.asarray(c))).to(dev)
    if not np.any(seq.camera.dist):
        return lambda chunk: to_dev(chunk).to(torch.float32)
    new_K = camera_mod.optimal_new_camera_matrix(seq.camera, alpha=1.0)
    src_map = camera_mod.undistort_rectify_map(seq.camera, new_K, device=dev)
    return lambda chunk: camera_mod.remap_bilinear(to_dev(chunk), src_map)


def preprocess_frames(seq: VOSequence, device="cuda") -> torch.Tensor:
    return make_preprocessor(seq, device)(seq.frames)


def effective_K(seq: VOSequence) -> np.ndarray:
    """Intrinsics valid for the (possibly undistorted) frames fed to VO."""
    if not np.any(seq.camera.dist):
        return np.asarray(seq.camera.K)
    return camera_mod.optimal_new_camera_matrix(seq.camera, alpha=1.0)


def effective_marker_corners(seq: VOSequence, new_K: np.ndarray) -> np.ndarray:
    """Marker corners in the pixel space of the preprocessed frames (NaN kept)."""
    corners = np.asarray(seq.marker_corners, np.float32)
    if not np.any(seq.camera.dist):
        return corners
    und = camera_mod.undistort_points(torch.from_numpy(np.nan_to_num(corners)), seq.camera, new_K=new_K)
    return np.where(np.isnan(corners), np.nan, und.numpy().astype(np.float32))


def gt_streams(seq: VOSequence) -> tuple[np.ndarray, np.ndarray]:
    """Marker ground truth: absolute cTm per frame and relative
    cTm_curr @ inv(cTm_prev) (float32, like the reference)."""
    gt_abs = np.asarray(seq.marker_poses, np.float64)
    g = torch.as_tensor(gt_abs, dtype=torch.float32)
    return gt_abs, se3.gt_relative(g[:-1], g[1:]).numpy()


def run_experiment(
    seq: VOSequence,
    cfg: VOConfig = VOConfig(),
    out_dir: str | None = None,
    seed: int = 0,
    backend: str = "none",
    refine_cfg=None,
    checkpoint_path: str | None = None,
    checkpoint_chunk: int = 256,
    stream: bool | None = None,
    *,
    device="cuda",
) -> ExperimentResult:
    """Full experiment on one sequence on `device` ("cuda" or "cpu"). Writes
    the six TUM streams when out_dir is given. backend: "none", "pose_graph"
    (refine_cfg a PoseGraphRefineConfig) or "ba" (a RefineConfig); None
    takes the backend's default config.

    stream: run VO in chunks of `checkpoint_chunk` pairs from host frames
    (an ndarray, np.memmap or StoreFrames), resumable from checkpoint_path.
    None turns it on for a checkpoint path or for frames over STREAM_BYTES
    as float32.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend: {backend}")
    with profiling.span("pipeline.run_experiment", backend=backend) as root:
        dev = resolve_device(device)
        with profiling.span("pipeline.camera"):
            preprocess = make_preprocessor(seq, dev)
            K = effective_K(seq).astype(np.float32)
            corners = effective_marker_corners(seq, K)
            if stream is None:
                stream = bool(checkpoint_path) or 4 * int(np.prod(seq.frames.shape)) > STREAM_BYTES
            first = int(np.argmax(seq.marker_present)) if seq.marker_present.any() else 0
            init_pose = np.asarray(seq.marker_poses[first], np.float32)
        if not stream:
            with profiling.span("pipeline.preprocess", device=dev):
                frames = preprocess(seq.frames)

        with profiling.span("vo.run", stream=bool(stream)):
            key = threefry.prng_key(seed, dev)  # both branches draw from PRNGKey(seed), as the reference's
            if stream:
                traj = run_sequence_checkpointed(
                    seq.frames, corners, np.asarray(seq.marker_present), init_pose, K, seq.real_marker_length, cfg,
                    path=checkpoint_path, chunk=checkpoint_chunk, preprocess=preprocess, device=dev, key=key,
                )
            else:
                traj = run_sequence(
                    frames, corners, np.asarray(seq.marker_present), init_pose, K,
                    seq.real_marker_length, cfg, key=key,
                )
        if stream:
            # The backends take the frames or a fetcher: here keyframes cross to
            # the device in blocks of a host gather.
            frames = HostFetcher(seq.frames, preprocess, dev)
        else:
            with profiling.span("vo.fetch"):
                traj = VOTrajectory(*(t.cpu().numpy() for t in traj))
                profiling.RECORDER.resolve()
        root.set(**_ransac_counts(traj, cfg))

        with profiling.span("pipeline.anchor"):
            gt_abs, gt_rel = gt_streams(seq)
            vo_abs = np.asarray(traj.abs_poses, np.float64)
            # Anchor at the first marker-bearing frame: abs_i <- abs_i @ inv(abs_first) @ init_pose.
            if first > 0:
                vo_abs = vo_abs @ (np.linalg.inv(vo_abs[first]) @ np.asarray(init_pose, np.float64))

        backend_info: dict = {}
        if backend == "pose_graph":
            vo_abs, backend_info = pose_graph_trajectory(
                frames, vo_abs, traj.n_inliers, corners, np.asarray(seq.marker_present), K,
                seq.real_marker_length, cfg, refine_cfg or PoseGraphRefineConfig(), pair_scale_ok=traj.scale_ok,
            )
        elif backend == "ba":
            vo_abs, backend_info = refine_trajectory(
                frames, vo_abs, traj.n_inliers, K, refine_cfg or RefineConfig(),
                marker_corners=corners, real_marker_length=seq.real_marker_length,
            )

        with profiling.span("pipeline.metrics"):
            v = torch.as_tensor(vo_abs, dtype=torch.float32)
            vo_rel = se3.gt_relative(v[:-1], v[1:]).numpy().astype(np.float64)
            # Metrics on the camera trajectory in the marker frame (mTc = inv(cTm)).
            present = seq.marker_present
            gt_cam = np.linalg.inv(gt_abs[present])
            vo_cam = np.linalg.inv(vo_abs[present])
            ate, rpe = metrics.ate(gt_cam, vo_cam, align="none"), metrics.rpe(gt_cam, vo_cam, delta=1)
        paths = None
        if out_dir is not None:
            with profiling.span("pipeline.tum"):
                paths = tum.write_experiment_streams(out_dir, seq.timestamps, gt_abs, gt_rel, vo_abs, vo_rel)
        return ExperimentResult(
            timestamps=seq.timestamps,
            gt_abs=gt_abs,
            gt_rel=gt_rel,
            vo_abs=vo_abs,
            vo_rel=vo_rel,
            trajectory=traj,
            ate=ate,
            rpe=rpe,
            stream_paths=paths,
            backend_info=backend_info,
        )


def _ransac_counts(traj: VOTrajectory, cfg: VOConfig) -> dict[str, int]:
    """The VO run's RANSAC work from its host arrays: frames, pairs,
    hypotheses drawn (pairs x cfg's hypotheses), matches and inliers."""
    pairs = int(np.asarray(traj.n_matches).shape[0])
    return dict(frames=pairs + 1, pairs=pairs, hypotheses=pairs * cfg.ransac.n_hypotheses,
                matches=int(np.sum(traj.n_matches)), inliers=int(np.sum(traj.n_inliers)))


class HostFetcher:
    """idx -> preprocess(host_frames[idx]) on `dev`, bit for bit, a block at
    a time: the streamed backends' keyframe fetch.

    The frames at idx are taken in blocks of `block` frames (FETCH_BLOCK_BYTES
    of raw frames). Each block is gathered on the host straight into one of
    two staging blocks (page-locked on a CUDA device; made at the first
    fetch and kept, so pinned host memory stays at two blocks whatever the
    keyframe count), copied to `dev` asynchronously and remapped there into
    its rows of the (K, H, W) result. So the host gathers block j + 1 while
    the card copies block j; a staging block is refilled once its last copy
    has ended. An ndarray source (np.memmap too) is gathered in runs of rows
    split over up to GATHER_THREADS host threads; any other host array-like
    (StoreFrames) through its own indexing.

    Spans: per block `refine.gather` (the host gather and the wait for its
    staging block; count `frames`) and `refine.upload` (the copy and remap,
    with their device interval); the enclosing span (`refine.fetch`) gets
    the counts `frames`, `blocks` and `pinned` (1 for page-locked blocks).
    """

    def __init__(self, host_frames, preprocess, dev):
        self.frames, self.preprocess, self.dev = host_frames, preprocess, torch.device(dev)
        self.pinned = self.dev.type == "cuda"
        self.shape = tuple(host_frames.shape[1:])
        dtype = np.dtype(host_frames.dtype)
        self.dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        self.block = max(1, FETCH_BLOCK_BYTES // (int(np.prod(self.shape)) * dtype.itemsize))
        self.threads = min(GATHER_THREADS, os.cpu_count() or 1)
        self.staging: list[torch.Tensor] = []
        self.copied = [torch.cuda.Event(), torch.cuda.Event()] if self.pinned else []

    def __call__(self, idx) -> torch.Tensor:
        idx = np.asarray(idx, np.int64).reshape(-1)
        n = int(self.frames.shape[0])
        if idx.size and not (-n <= idx.min() and idx.max() < n):
            raise IndexError(f"frame index out of range for {n} frames")
        idx = np.where(idx < 0, idx + n, idx)
        if not self.staging:
            self.staging = [torch.empty((self.block,) + self.shape, dtype=self.dtype, pin_memory=self.pinned)
                            for _ in range(2)]
        out = None
        starts = range(0, len(idx), self.block)
        with ThreadPoolExecutor(self.threads) as pool:
            for j, a in enumerate(starts):
                rows = idx[a : a + self.block]
                buf = self.staging[j % 2][: len(rows)]
                with profiling.span("refine.gather", frames=len(rows)):
                    if self.pinned:
                        self.copied[j % 2].synchronize()  # the block's previous copy has ended
                    _gather(self.frames, rows, buf.numpy(), pool, self.threads)
                with profiling.span("refine.upload", device=self.dev):
                    raw = buf.to(self.dev, non_blocking=True)
                    if self.pinned:
                        self.copied[j % 2].record(torch.cuda.current_stream(self.dev))
                    y = self.preprocess(raw)
                    if out is None:
                        out = torch.empty((len(idx),) + tuple(y.shape[1:]), dtype=y.dtype, device=y.device)
                    out[a : a + len(rows)] = y
        profiling.current().set(frames=len(idx), blocks=len(starts), pinned=int(self.pinned))
        return out if out is not None else self.preprocess(np.empty((0,) + self.shape, self.frames.dtype))


def _gather(src, rows: np.ndarray, out: np.ndarray, pool: ThreadPoolExecutor, threads: int) -> None:
    """out[k] = src[rows[k]] for in-range rows: an ndarray source in runs of
    rows split over `threads` of the pool's threads (np.take releases the
    GIL), any other through its own indexing."""
    if not isinstance(src, np.ndarray):
        out[...] = src[rows]
        return
    cuts = np.linspace(0, len(rows), min(threads, len(rows)) + 1).astype(int)
    parts = [pool.submit(np.take, src, rows[lo:hi], 0, out[lo:hi], "clip") for lo, hi in zip(cuts[:-1], cuts[1:])]
    for f in parts:
        f.result()


def dump_match_images(
    seq: VOSequence,
    cfg: VOConfig,
    out_dir: str,
    n_pairs: int = 4,
    seed: int = 0,
    max_draw: int = 100,
    *,
    device="cuda",
) -> list[str]:
    """Side-by-side matched-keypoint debug images for evenly spaced frame
    pairs (RANSAC inliers green, outliers red), a keypoint overlay of the
    first pair's first frame, and the marker corners where both frames have
    the marker. Each pair runs on `device` as a two-frame batch: the
    frontend, the match at P = 1, LO-RANSAC drawing from fold_in(PRNGKey(seed),
    pair) (the reference's pipeline.py:317). Returns the written paths."""
    import os

    from droplet_visual_odometry_tpu_torch.estimation.ransac import ransac_pose
    from droplet_visual_odometry_tpu_torch.eval import plots
    from droplet_visual_odometry_tpu_torch.frontend import matcher
    from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch

    os.makedirs(out_dir, exist_ok=True)
    n = len(seq)
    if n < 2:
        return []
    pair_starts = sorted({int(i) for i in np.linspace(0, n - 2, max(1, min(n_pairs, n - 1)))})
    dev = resolve_device(device)
    preprocess = make_preprocessor(seq, dev)
    K = torch.as_tensor(effective_K(seq), dtype=torch.float32, device=dev)
    key = threefry.prng_key(seed, dev)

    paths: list[str] = []
    for i in pair_starts:
        frames = preprocess(seq.frames[i : i + 2])
        feats = detect_and_describe_batch(
            frames,
            k=cfg.n_keypoints,
            threshold=cfg.fast_threshold,
            mode=cfg.frontend,
            dog_threshold=cfg.dog_threshold,
            n_levels=cfg.n_levels if cfg.frontend == "orb" else 1,
            scale_factor=cfg.scale_factor,
        )
        m = matcher.match(feats.desc[:1], feats.desc[1:], feats.valid[:1], feats.valid[1:],
                          mode=cfg.match_mode, ratio=cfg.ratio)
        p_prev, p_curr, valid = matcher.gather_correspondences(feats.xy[:1], feats.xy[1:], m)
        _, _, res = ransac_pose(p_prev, p_curr, valid, K, cfg.ransac, keys=threefry.fold_in(key, i)[None])
        fa, fb = frames[0].cpu().numpy(), frames[1].cpu().numpy()
        xy = feats.xy.cpu().numpy()
        path = os.path.join(out_dir, f"match_{i:05d}.png")
        plots.plot_matches(
            path, fa, fb, xy[0], xy[1], m.idx[0].cpu().numpy(), m.valid[0].cpu().numpy(),
            inliers=res.inliers[0].cpu().numpy(), max_draw=max_draw,
            title=f"pair {i}->{i+1} ({cfg.frontend}/{cfg.match_mode})",
        )
        paths.append(path)
        if i == pair_starts[0]:
            kp_path = os.path.join(out_dir, f"keypoints_{i:05d}.png")
            plots.plot_keypoints(kp_path, fa, xy[0], feats.valid[0].cpu().numpy(), title=f"frame {i} ({cfg.frontend})")
            paths.append(kp_path)
        if seq.marker_present[i] and seq.marker_present[i + 1]:
            mc_path = os.path.join(out_dir, f"marker_corners_{i:05d}.png")
            plots.plot_marker_corners(
                mc_path, np.asarray(seq.marker_corners[i]), np.asarray(seq.marker_corners[i + 1]),
                frame=fa, title=f"marker corners {i}->{i+1}",
            )
            paths.append(mc_path)
    return paths
