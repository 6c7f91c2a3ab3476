"""Checkpoint/resume and host-to-device streaming of long VO runs — port of
droplet_visual_odometry_tpu/utils/checkpoint.py.

The sequence runs in fixed-size chunks of pairs, each one call of
estimation/vo.run_sequence, with the carry (next frame index, last absolute
pose, last held scale, whether a live scale was seen, the trajectory so far)
written to an .npz after every chunk by an atomic write-and-rename, so a run
of the reference's length (25,075 frames at 1440x1080) resumes after its
last completed chunk.

`frames` may be any host array-like (an ndarray, an np.memmap or a
data.native_store.StoreFrames): only one chunk of raw frames crosses to the
device at a time, through one page-locked host buffer reused for every
chunk, and `preprocess` (the uint8 -> float32 cast and undistortion) runs on
the device inside the loop, outside the VO program (as the reference's remap
is jitted apart). Whole-sequence frames never exist on the device. Every
chunk, the padded last one included, has one shape, so on the card every
chunk replays one captured run_sequence program (utils/graphs.py), its
preprocessed frames copied device to device into the program's input.

Random draws: the reference's. The chunk whose first pair ends at frame
`start` runs under fold_in(key, start) (checkpoint.py:127), a function of
(key, start) alone, so a resumed run draws what the uninterrupted run drew;
`draws(start, n_pairs)` injects a chunk's uniforms instead. The state file
keeps the run key, as the reference's does.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable

import numpy as np
import torch

from plainref.estimation.vo import VOConfig, VOTrajectory, run_sequence
from plainref.utils import threefry
from plainref.utils.device import resolve_device

_FIELDS = ("abs_poses", "rel_poses", "n_matches", "n_inliers", "scales", "scale_ok", "ok")


def save_state(path: str, state: dict[str, np.ndarray]) -> None:
    """Atomic npz write: a temporary file in the same directory, then os.replace."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **state)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str) -> dict[str, np.ndarray] | None:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def run_sequence_checkpointed(
    frames,  # (N, H, W) host array-like: ndarray / np.memmap / StoreFrames
    marker_corners: np.ndarray,
    marker_present: np.ndarray,
    init_pose: np.ndarray,
    K: np.ndarray,
    real_marker_length: float,
    cfg: VOConfig = VOConfig(),
    *,
    path: str | None,
    chunk: int = 256,
    seed: int = 0,
    preprocess: Callable[[torch.Tensor], torch.Tensor] | None = None,
    progress: Callable[[int, int], None] | None = None,
    draws: Callable[[int, int], tuple[torch.Tensor, torch.Tensor]] | None = None,
    device="cuda",
    key: torch.Tensor | None = None,
) -> VOTrajectory:
    """run_sequence over `frames` in chunks of `chunk` pairs, resumable from
    `path` (None streams without persistence). Returns the trajectory as
    numpy arrays.

    Chunks cover pairs [start, start+chunk), frames start-1 .. stop-1, so
    the pair straddling a boundary is computed once. The last partial chunk
    is padded to the full shape (its last frame repeated, marker absent);
    the padded pairs are sliced off before anything reads them. A state of
    another `n` or `chunk` restarts the run.

    preprocess maps a chunk's raw frames, already on `device`, to the float32
    frames VO consumes (default: a cast). The run key is PRNGKey(seed)
    unless `key` is given; draws(start, n_pairs) -> (u_hyp, u_lo) replaces
    a chunk's keyed draws with injected uniforms.
    """
    n = int(frames.shape[0])
    if n < 2:
        raise ValueError("need at least 2 frames")
    dev = resolve_device(device)
    if preprocess is None:
        preprocess = lambda c: c.to(torch.float32)
    key = threefry.prng_key(seed, dev) if key is None else key.to(dev)
    key_words = key.cpu().numpy().astype(np.uint32)

    state = load_state(path) if path else None
    if state is not None and int(state["n_total"]) == n and int(state["chunk"]) == chunk:
        start = int(state["next_start"])
        acc = {f: [state[f]] for f in _FIELDS}
        abs_last = state["abs_last"]
        # State files written before the scale carry existed lack these two
        # entries: the reference's defaults.
        scale_last = float(state.get("scale_last", 1.0))
        scale_seen = bool(state.get("scale_seen", False))
    else:
        start = 1  # the current frame of the next pair
        acc = {f: [] for f in _FIELDS}
        abs_last = np.asarray(init_pose, np.float32)
        scale_last = 1.0
        scale_seen = False

    # One page-locked staging buffer for every chunk: raw frames cross to the
    # card in their own dtype and are cast there by `preprocess`.
    dtype = torch.from_numpy(np.empty(0, np.dtype(frames.dtype))).dtype
    staging = torch.empty((chunk + 1,) + tuple(frames.shape[1:]), dtype=dtype, pin_memory=dev.type == "cuda")
    host = staging.numpy()
    while start < n:
        stop = min(start + chunk, n)
        n_real = stop - (start - 1)  # frames of this chunk before padding
        host[:n_real] = frames[start - 1 : stop]
        host[n_real:] = host[n_real - 1]
        mc = np.empty((chunk + 1, 4, 2), np.float32)
        mc[:n_real] = marker_corners[start - 1 : stop]
        mc[n_real:] = mc[n_real - 1]
        mp = np.zeros(chunk + 1, bool)
        mp[:n_real] = marker_present[start - 1 : stop]
        u_hyp, u_lo = draws(start, chunk) if draws is not None else (None, None)
        traj = run_sequence(
            preprocess(staging.to(dev, non_blocking=True)), mc, mp, abs_last, K, real_marker_length, cfg,
            u_hyp=u_hyp, u_lo=u_lo, init_scale=scale_last, init_scale_seen=scale_seen,
            key=None if u_hyp is not None else threefry.fold_in(key, start),
        )
        traj = VOTrajectory(*(t.cpu().numpy() for t in traj))
        n_pairs = n_real - 1
        # abs_poses[0] repeats the carried pose: keep only the chunk's new frames.
        acc["abs_poses"].append(traj.abs_poses[1 : 1 + n_pairs])
        for f in _FIELDS[1:]:
            acc[f].append(getattr(traj, f)[:n_pairs])
        abs_last = traj.abs_poses[n_pairs]
        scale_last = float(traj.scales[n_pairs - 1])
        scale_seen = scale_seen or bool(np.any(traj.scale_ok[:n_pairs]))
        start = stop
        # progress before the save, as in the reference: an exception in the
        # callback leaves this chunk unsaved, and a resume recomputes it.
        if progress is not None:
            progress(stop, n)
        if path:
            save_state(path, {
                "n_total": np.asarray(n),
                "chunk": np.asarray(chunk),
                "next_start": np.asarray(start),
                "abs_last": abs_last,
                "scale_last": np.asarray(scale_last),
                "scale_seen": np.asarray(scale_seen),
                "key": key_words,
                **{f: np.concatenate(acc[f], axis=0) for f in _FIELDS},
            })

    out = {f: np.concatenate(acc[f], axis=0) for f in _FIELDS}
    out["abs_poses"] = np.concatenate([np.asarray(init_pose, np.float32)[None], out["abs_poses"]], axis=0)
    return VOTrajectory(**out)
