"""Online (streaming) visual odometry: the live-node engine — port of
droplet_visual_odometry_tpu/stream.py.

`OnlineVO.push(timestamp, frame, markers)` is one image callback and marker
callback of the reference's live ROS node: marker-gated (before the first
marker a frame only primes the engine; the first marker arms it and seeds
the pose), one frame a push, features carried forward, `on_pose` and
per-marker `on_marker` callbacks. Marker handling runs on the host in numpy.

The reference builds each push as ONE compiled program (the f32 cast, the
single-frame detect and describe, `two_frame_vo` on one pair) with one
device_get after it. Here, on the card, each engine captures that step as
ONE CUDA graph at its first armed push and replays it after that; a push
then is: the raw frame, both frames' marker corners and the marker flag
copied to static device buffers through one page-locked staging buffer,
one replay, and one fetch of (rel, n_inliers, ok, n_matches). On the CPU the
same step runs eagerly: graphs exist only on CUDA devices, so the device
decides, and a capture that fails raises.

RANSAC draws: the reference's. Push `step` draws from fold_in(PRNGKey(seed),
step) (stream.py:112), through `ring_draws`: one batched threefry call makes
the draws of DRAW_BLOCK consecutive pushes on the engine's device, and each
push copies its row into the graph's static buffers (device to device)
before the replay. Made inside the graph instead, the draws cost every
replay ~520 more nodes. On the card the two forms' median pushes differ by
under 1 ms, in either direction by run; the ring's mean push, refills
included, was the lower, at the price of one push in DRAW_BLOCK that makes
the next block (PERF.md, section 6). An injected `draws(step) -> (u_hyp (1, B*8), u_lo (1,
L*14) or (1, 2, L*14))` replaces them. The kernels' launch counters tick
while a step runs eagerly or is captured, not on a replay:
`captured_launches` holds the capture's, the launches of every replay.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig, two_frame_vo
from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe
from droplet_visual_odometry_tpu_torch.frontend.orb import Features
from droplet_visual_odometry_tpu_torch.groundtruth import GroundTruthConfig, MarkerDetections, marker_pose_to_cTm
from droplet_visual_odometry_tpu_torch.utils import graphs, profiling, threefry
from droplet_visual_odometry_tpu_torch.utils.device import resolve_device

Draws = Callable[[int], tuple[torch.Tensor, torch.Tensor | None]]

DRAW_BLOCK = 256  # pushes whose draws one batched threefry call makes

# Byte layout of the staging buffer: previous and current marker corners
# (4 x 2 float32 each), the marker flag, then the raw frame 16-byte aligned.
_PC, _CC, _MV, _FRAME = 0, 32, 64, 80


def ring_draws(key: torch.Tensor, ransac_cfg) -> Draws:
    """draws(step) of the reference's pushes: the uniforms of fold_in(key,
    step), made for DRAW_BLOCK consecutive steps at once (one
    ransac_uniforms call over their keys, on the key's device) and handed
    out row by row. A step outside the current block starts a new one at
    that step."""
    ring = {}

    def draws(step: int):
        if not ring or not ring["start"] <= step < ring["start"] + DRAW_BLOCK:
            steps = torch.arange(step, step + DRAW_BLOCK, dtype=torch.int64, device=key.device)
            ring.update(start=step, u=threefry.ransac_uniforms(threefry.fold_in(key, steps), ransac_cfg))
        i = step - ring["start"]
        u_hyp, u_lo = ring["u"]
        return u_hyp[i:i + 1], None if u_lo is None else u_lo[i:i + 1]

    return draws


@dataclasses.dataclass
class StreamResult:
    """One push()'s outcome."""

    timestamp: float
    pose: np.ndarray  # (4, 4) absolute pose estimate (cTm frame)
    rel: np.ndarray  # (4, 4) relative pose of this step (identity if primed/skipped)
    gt_pose: np.ndarray | None  # marker-derived cTm when a marker was seen
    n_inliers: int
    ok: bool
    armed: bool
    n_matches: int = 0  # matches of this step (the port adds it; 0 if primed)


class OnlineVO:
    """Marker-gated streaming VO engine on one device.

    Frames must arrive in timestamp order, all of one shape and dtype (the
    first pins them; a frame that differs raises), as host arrays or as
    tensors already on the engine's device (copied device to device into
    the step's input). `device` defaults to the card; "cuda" without one
    raises.
    """

    def __init__(
        self,
        K: np.ndarray,
        real_marker_length: float,
        reference_id: int = 0,
        cfg: VOConfig = VOConfig(),
        gt_cfg: GroundTruthConfig = GroundTruthConfig(),
        seed: int = 0,
        *,
        device="cuda",
        draws: Draws | None = None,
    ) -> None:
        self.cfg = cfg
        self.gt_cfg = gt_cfg
        self.reference_id = reference_id
        self.device = resolve_device(device)
        self.K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
        self.real_marker_length = float(real_marker_length)
        self.seed = seed
        self.draws = draws if draws is not None else ring_draws(threefry.prng_key(seed, self.device), cfg.ransac)
        self._armed = False
        self._pose = np.eye(4, dtype=np.float32)
        self._step = 0
        self._prev_corners = np.zeros((4, 2), np.float32)
        self._prev_valid = False
        self._prev_feats: Features | None = None
        self._frame_spec: tuple[tuple[int, ...], torch.dtype] | None = None  # pinned by the first frame
        self._graph: torch.cuda.CUDAGraph | None = None
        self._static: dict | None = None
        # Kernel launches in the captured graph, i.e. per replayed push (set at capture).
        self.captured_launches: dict[str, int] | None = None
        self.on_pose: list[Callable[[float, np.ndarray], None]] = []
        # Per-marker broadcast: (timestamp, marker_id, cTm) for every detected marker.
        self.on_marker: list[Callable[[float, int, np.ndarray], None]] = []
        # The reference builds its detector without cfg.n_levels and
        # cfg.scale_factor (the pyramid defaults), unlike run_sequence; kept.
        self._detect_kw = dict(
            k=cfg.n_keypoints, threshold=cfg.fast_threshold, arc_length=cfg.fast_arc_length,
            mode=cfg.frontend, dog_threshold=cfg.dog_threshold,
        )
        # Host copy of the fixed extrinsic for the per-push marker math.
        self._cTb_np = gt_cfg.camera_T_base().numpy().astype(np.float64)

    # -- marker handling ----------------------------------------------------
    def _marker_info(self, markers: MarkerDetections | None):
        """(cTm or None, corners (4, 2), valid) of the reference marker, in host numpy."""
        if markers is None:
            return None, np.zeros((4, 2), np.float32), False
        ids = np.asarray(markers.ids[0])
        hit = ids == self.reference_id
        if not hit.any():
            return None, np.zeros((4, 2), np.float32), False
        s = int(np.argmax(hit))
        t = np.asarray(markers.translations[0][s], np.float64)
        q = np.asarray(markers.quaternions[0][s], np.float64)  # xyzw
        q = q / max(np.linalg.norm(q), 1e-12)
        x, y, z, w = q
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        bTm = np.eye(4)
        bTm[:3, :3] = R
        bTm[:3, 3] = t
        cTm = (self._cTb_np @ bTm) if self.gt_cfg.use_base_link else bTm
        corners = np.asarray(markers.corners[0][s], np.float32)
        return cTm.astype(np.float32), corners, True

    def _broadcast_markers(self, timestamp: float, markers: MarkerDetections) -> None:
        """Fire on_marker for every detected marker slot (id >= 0)."""
        ids = np.asarray(markers.ids[0])
        if not (ids >= 0).any():
            return
        cTms = marker_pose_to_cTm(torch.as_tensor(markers.translations[0]), torch.as_tensor(markers.quaternions[0]),
                                  self.gt_cfg).numpy()
        for slot in np.flatnonzero(ids >= 0):
            for cb in self.on_marker:
                cb(float(timestamp), int(ids[slot]), cTms[slot])

    # -- main entry ---------------------------------------------------------
    def push(self, timestamp: float, frame: np.ndarray | torch.Tensor,
             markers: MarkerDetections | None = None) -> StreamResult:
        """Process one frame (and the marker detections of the same stamp):
        the chained pose estimate. Until the first marker the engine stays
        unarmed and frames only prime it. One push is one root span,
        `online.push` (counts `inliers`, `matches`; see _replay)."""
        with profiling.span("online.push") as rec:
            self._check_frame(frame)
            gt_pose, corners, mvalid = self._marker_info(markers)
            if markers is not None and self.on_marker:
                self._broadcast_markers(timestamp, markers)

            if not self._armed:
                if gt_pose is not None:  # the first marker arms the engine and seeds the pose
                    self._armed = True
                    self._pose = np.asarray(gt_pose, np.float32)
                self._prime(frame, corners, mvalid)
                return self._result(timestamp, np.eye(4, dtype=np.float32), gt_pose, 0, self._armed)

            self._step += 1
            marker_valid = bool(self._prev_valid) and bool(mvalid)
            if self.device.type == "cuda":
                out = self._replay(frame, corners, marker_valid)
            else:
                self._prev_feats, out = self._run_eager(frame, corners, marker_valid, self._step)
            rel = out[:16].numpy().reshape(4, 4)
            self._pose = rel @ self._pose
            self._prev_corners = np.asarray(corners, np.float32)
            self._prev_valid = mvalid
            n_inliers, n_matches = int(out[16]), int(out[18])
            rec.set(inliers=n_inliers, matches=n_matches)
            return self._result(timestamp, rel, gt_pose, n_inliers, bool(out[17]), n_matches)

    def step_eager(self, frame: np.ndarray, markers: MarkerDetections | None = None) -> torch.Tensor:
        """What the next armed push of this frame computes, run op by op on
        the engine's device with the same features, corners and draws, and
        without advancing the engine: (19,) host float32 [rel (16),
        n_inliers, ok, n_matches]. On the card it is the graph's eager twin."""
        if not self._armed:
            raise RuntimeError("step_eager: the engine is not armed")
        self._check_frame(frame)
        _, corners, mvalid = self._marker_info(markers)
        return self._run_eager(frame, corners, bool(self._prev_valid) and bool(mvalid), self._step + 1)[1]

    # -- the device step ----------------------------------------------------
    def _draws(self, step: int) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(u_hyp (1, B*8), u_lo (1, rounds, L*14) or None) of push `step`."""
        u_hyp, u_lo = self.draws(step)
        if u_lo is not None and u_lo.dim() == 2:
            u_lo = u_lo[:, None]
        return u_hyp, u_lo

    def _step_body(self, frame, feats_prev: Features, pc, cc, mv, u_hyp, u_lo) -> tuple[Features, torch.Tensor]:
        """The push's device program: f32 cast, detect and describe, two_frame_vo
        at P = 1; returns the current features and (rel (16), n_inliers, ok,
        n_matches) packed as 19 float32 (exact integers) for one fetch."""
        feats_curr = detect_and_describe(frame.to(torch.float32), **self._detect_kw)
        res = two_frame_vo(
            Features(*(a[None] for a in feats_prev)), Features(*(a[None] for a in feats_curr)),
            pc[None], cc[None], mv.reshape(1), self.K, self.real_marker_length, self.cfg,
            u_hyp=u_hyp, u_lo=u_lo,
        )
        out = torch.cat([res.rel.reshape(16), res.n_inliers.to(torch.float32), res.ok.to(torch.float32),
                         res.n_matches.to(torch.float32)])
        return feats_curr, out

    def _run_eager(self, frame, corners, marker_valid: bool, step: int) -> tuple[Features, torch.Tensor]:
        """Push `step`'s device step op by op on the carried features:
        (current features, (19,) host float32 output)."""
        dev = self.device
        u_hyp, u_lo = (None if u is None else u.to(dev) for u in self._draws(step))
        prev = self._static["prev"] if self._static is not None else self._prev_feats
        feats_curr, out = self._step_body(
            self._on_device(frame), prev,
            torch.as_tensor(self._prev_corners, device=dev),
            torch.as_tensor(np.asarray(corners, np.float32), device=dev),
            torch.tensor(bool(marker_valid), device=dev),
            u_hyp, u_lo,
        )
        return feats_curr, out.cpu()

    def _check_frame(self, frame) -> None:
        """Pin the first frame's shape and dtype; raise on a frame that differs."""
        if isinstance(frame, torch.Tensor):
            spec = (tuple(frame.shape), frame.dtype)
        else:
            frame = np.asarray(frame)
            spec = (frame.shape, torch.from_numpy(np.empty(0, frame.dtype)).dtype)
        if self._frame_spec is None:
            self._frame_spec = spec
        elif spec != self._frame_spec:
            raise ValueError(f"frame of shape {spec[0]} and dtype {spec[1]}: the engine's frames are "
                             f"{self._frame_spec[0]}, {self._frame_spec[1]}")

    def _on_device(self, frame) -> torch.Tensor:
        if isinstance(frame, torch.Tensor):
            return frame.to(self.device)
        return torch.as_tensor(np.asarray(frame), device=self.device)

    def _prime(self, frame, corners, mvalid) -> None:
        self._prev_feats = detect_and_describe(self._on_device(frame).to(torch.float32), **self._detect_kw)
        self._prev_corners = np.asarray(corners, np.float32)
        self._prev_valid = mvalid

    def _stage(self, frame, corners, marker_valid: bool) -> None:
        """One page-locked staging buffer -> the static device inputs, one copy."""
        st = self._static
        host = st["host"].numpy()
        host[_PC:_CC].view(np.float32)[:] = self._prev_corners.reshape(-1)
        host[_CC:_MV].view(np.float32)[:] = np.asarray(corners, np.float32).reshape(-1)
        host[_MV] = bool(marker_valid)
        if isinstance(frame, torch.Tensor):  # already on the card: only the marker bytes cross
            st["dev"][:_FRAME].copy_(st["host"][:_FRAME], non_blocking=True)
            st["frame"].copy_(frame.reshape(st["frame"].shape))
        else:
            host[_FRAME:].view(st["frame_dtype"])[:] = np.asarray(frame).reshape(-1)
            st["dev"].copy_(st["host"], non_blocking=True)
        u_hyp, u_lo = self._draws(self._step)
        st["u_hyp"].copy_(u_hyp, non_blocking=True)
        if u_lo is not None:
            st["u_lo"].copy_(u_lo, non_blocking=True)

    def _replay(self, frame, corners, marker_valid: bool) -> torch.Tensor:
        """The push on the card: stage, replay the captured graph (capture it
        at the first armed push), fetch; spans `online.capture`,
        `online.stage`, `online.replay` (with its device interval) and
        `online.fetch`."""
        if self._graph is None:
            with profiling.span("online.capture"):
                self._capture(frame)
        with profiling.span("online.stage"):
            self._stage(frame, corners, marker_valid)
        with profiling.span("online.replay", device=self.device):
            self._graph.replay()
        with profiling.span("online.fetch"):
            return self._static["out"].cpu()

    def _capture(self, frame: np.ndarray | torch.Tensor) -> None:
        """Build the static buffers from the carried features and capture the
        step as one CUDA graph; a warm-up run on a side stream first builds
        every per-device constant and kernel library outside the capture."""
        dev = self.device
        shape, tdtype = self._frame_spec
        fb = int(np.prod(shape)) * tdtype.itemsize
        host = torch.empty(_FRAME + fb, dtype=torch.uint8, pin_memory=True)
        dev_buf = torch.empty(_FRAME + fb, dtype=torch.uint8, device=dev)
        st = dict(
            host=host, dev=dev_buf, frame_dtype=torch.empty(0, dtype=tdtype).numpy().dtype,
            frame=dev_buf[_FRAME:].view(tdtype).view(shape),
            pc=dev_buf[_PC:_CC].view(torch.float32).view(4, 2),
            cc=dev_buf[_CC:_MV].view(torch.float32).view(4, 2),
            mv=dev_buf[_MV:_MV + 1].view(torch.bool),
            prev=Features(*(a.clone() for a in self._prev_feats)),
        )
        u_hyp, u_lo = self._draws(self._step)
        st["u_hyp"] = torch.empty(u_hyp.shape, dtype=torch.float32, device=dev)
        st["u_lo"] = None if u_lo is None else torch.empty(u_lo.shape, dtype=torch.float32, device=dev)
        self._static = st
        self._stage(frame, np.zeros((4, 2), np.float32), False)

        def body():
            return self._step_body(st["frame"], st["prev"], st["pc"], st["cc"], st["mv"], st["u_hyp"], st["u_lo"])

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()  # warm-up: no carry, so the static previous features stay as they are
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = graphs.launch_counts()
        with torch.cuda.graph(graph):
            feats_curr, out = body()
            for dst, src in zip(st["prev"], feats_curr):
                dst.copy_(src)
            st["out"] = out
        self.captured_launches = {k: v - before[k] for k, v in graphs.launch_counts().items()}
        self._graph = graph

    # -- helpers ------------------------------------------------------------
    def _result(self, timestamp, rel, gt_pose, n_inliers, ok, n_matches=0) -> StreamResult:
        pose = np.asarray(self._pose, np.float32).copy()
        for cb in self.on_pose:
            cb(timestamp, pose)
        return StreamResult(
            timestamp=float(timestamp),
            pose=pose,
            rel=np.asarray(rel, np.float32),
            gt_pose=None if gt_pose is None else np.asarray(gt_pose, np.float32),
            n_inliers=n_inliers,
            ok=ok,
            armed=self._armed,
            n_matches=n_matches,
        )

    @property
    def pose(self) -> np.ndarray:
        return np.asarray(self._pose, np.float32).copy()

    @property
    def armed(self) -> bool:
        return self._armed
