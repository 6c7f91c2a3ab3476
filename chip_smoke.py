#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases (any failure raises, so the exit code is non-zero):
  1. environment: require CUDA, print the card, build the kernels from csrc/;
  2. data: render the 24-frame 1440x1080 synthetic workload of bench.py;
  3. each kernel against its plain PyTorch twin on the card, at the shapes
     the main path gives it (FAST on the four pyramid levels, patches at the
     real keypoint origins, match on the 23 real descriptor pairs plus a
     random K=2048 case), with kernel and plain times from CUDA events;
  4. the port's main path, pipeline.run_experiment(backend="none",
     device="cuda"), with every kernel's launch counter checked, the poses,
     pair status and TUM files checked, the ATE held against the JAX
     reference, and the warm frames/s of run_sequence;
  5. with --profile only: each stage of run_sequence timed alone (host
     clock, synchronised, median of 7) and torch.profiler over three warm
     runs (CUDA kernels per run, device busy ms, device idle share, the
     top kernels by device time and the top aten ops by count), printed as
     one JSON line {"profile": {...}}.
Then one JSON line with the per-kernel results, and last the line
{"ok": true, "device": {...}}.

It imports nothing of JAX. Without a GPU, or without the rest of the
repository beside it, it fails before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# bench.py:43-56 — the reference's benchmark workload.
SEQ_CONFIG = dict(
    n_frames=24, width=1440, height=1080, fx=1170.0, fy=1170.0, n_landmarks=900, landmark_size=0.07
)
SEED = 0

# The JAX package's run_experiment(backend="none") over this sequence, run on
# a CPU: ATE RMSE (m) with RANSAC seeds 0-3 = 0.01515 / 0.02519 / 0.01056 /
# 0.00674, and per-pair crosscheck match counts (the same for every seed: no
# random draw comes before RANSAC). The port draws its RANSAC samples from a
# torch.Generator, not threefry, so it cannot repeat one seed's run: its ATE
# is held to seed 0's value within twice the reference's own seed-to-seed
# spread around it (0.0067-0.0252 m), and its match counts, which no random
# draw touches, to the reference's within 2% in total.
JAX_ATE_RMSE = 0.01515
ATE_TOL = 0.02
JAX_N_MATCHES = [241, 247, 252, 230, 240, 253, 243, 257, 247, 243, 243, 233, 237, 230, 247, 269, 243, 245, 242, 264, 227, 229, 252]
MATCH_TOL = 0.02

REPLACES = {
    "fast_score": "droplet_visual_odometry_tpu/ops/pallas_fast.py:193",
    "extract_patches": "droplet_visual_odometry_tpu/ops/pallas_patches.py:103",
    "hamming_match": "droplet_visual_odometry_tpu/ops/pallas_match.py:105",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms, from CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_environment():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; a CUDA GPU is required")
    import droplet_visual_odometry_tpu_torch as port
    from droplet_visual_odometry_tpu_torch.ops import build

    # The port and its kernel sources must come from this checkout, not an installed copy.
    here = os.path.dirname(os.path.abspath(__file__))
    if os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))) != here:
        raise RuntimeError(f"chip_smoke: the port was imported from {port.__file__}, not from {here}")

    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {name}, compute capability {cap[0]}.{cap[1]}, count {torch.cuda.device_count()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    build.library()
    log(f"kernels built in {build.last_build_seconds:.2f} s (loaded in {time.perf_counter() - t0:.2f} s) "
        f"from {', '.join(os.path.relpath(s) for s in build.sources())}")
    return name


def phase_data():
    from droplet_visual_odometry_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    seq = synthetic.render_sequence(synthetic.SyntheticConfig(**SEQ_CONFIG))
    log(f"rendered {seq.frames.shape} uint8 frames in {time.perf_counter() - t0:.1f} s")
    return seq


def phase_kernels(seq):
    from droplet_visual_odometry_tpu_torch.frontend import fast, features, filters
    from droplet_visual_odometry_tpu_torch.frontend.orb import patch_origins
    from droplet_visual_odometry_tpu_torch.ops import cuda_fast, cuda_match, cuda_patches

    frames = torch.as_tensor(seq.frames).cuda().float()
    n, h0, w0 = frames.shape
    k = 512
    shapes = features.level_shapes(h0, w0, features.N_LEVELS, features.SCALE_FACTOR)
    budgets = features.level_budgets(k, features.N_LEVELS, features.SCALE_FACTOR)
    results = {}

    # Kernel 1: FAST on every pyramid level; kernel 2: patches at the level's real origins.
    fast_err = patch_err = 0.0
    fast_ms = fast_plain_ms = patch_ms = patch_plain_ms = 0.0
    level = frames
    for l, (lh, lw) in enumerate(shapes):
        if l > 0:
            level = filters.resize_bilinear(level, lh, lw).contiguous()
        out_k = cuda_fast.fast_score_cuda(level, 20.0, 9)
        out_p = cuda_fast.fast_score_plain(level, 20.0, 9)
        torch.cuda.synchronize()
        if not torch.equal(out_k > 0, out_p > 0):
            raise AssertionError(f"FAST level {l}: corner sets differ ({int((out_k > 0).ne(out_p > 0).sum())} px)")
        err = float((out_k - out_p).abs().max())
        if err > 1e-3:  # same f32 ops in the same neighbour order: expected 0
            raise AssertionError(f"FAST level {l}: max |kernel - plain| = {err}")
        fast_err = max(fast_err, err)
        fast_ms += median_ms(lambda: cuda_fast.fast_score_cuda(level, 20.0, 9))
        fast_plain_ms += median_ms(lambda: cuda_fast.fast_score_plain(level, 20.0, 9), reps=3, warmup=1)
        log(f"fast_score level {l} {tuple(level.shape)}: corners {int((out_k > 0).sum())}, max err {err}")

        kps = fast.select_topk_rows(fast.nms3x3(out_k), budgets[l])
        blur = filters.gaussian_blur(level, 2.0, 4, compute_dtype=torch.bfloat16).contiguous()
        origins = patch_origins(kps.xy, lh, lw)
        pk = cuda_patches.extract_patches_cuda(blur, origins, check=True)
        pp = cuda_patches.extract_patches_plain(blur, origins)
        err = float((pk - pp).abs().max())
        if err != 0.0:  # a pure copy
            raise AssertionError(f"patches level {l}: max |kernel - plain| = {err}")
        patch_err = max(patch_err, err)
        patch_ms += median_ms(lambda: cuda_patches.extract_patches_cuda(blur, origins))
        patch_plain_ms += median_ms(lambda: cuda_patches.extract_patches_plain(blur, origins))
        log(f"extract_patches level {l}: {origins.shape[0]} patches, max err {err}")
    results["fast_score"] = dict(max_abs_err=fast_err, ms=fast_ms, plain_ms=fast_plain_ms,
                                 source="droplet_visual_odometry_tpu_torch/csrc/fast_score.cu")
    results["extract_patches"] = dict(max_abs_err=patch_err, ms=patch_ms, plain_ms=patch_plain_ms,
                                      source="droplet_visual_odometry_tpu_torch/csrc/extract_patches.cu")

    # Kernel 3: the 23 real descriptor pairs at K=512, plus random K=2048 sets with invalid masks.
    feats = features.detect_and_describe_batch(frames, k=k)
    cases = [("real K=512", feats.desc[:-1].contiguous(), feats.desc[1:].contiguous(),
              feats.valid[:-1].contiguous(), feats.valid[1:].contiguous())]
    g = torch.Generator(device="cuda").manual_seed(1)
    k2 = 2048
    rand_desc = lambda: torch.randint(-2**31, 2**31 - 1, (4, k2, 8), generator=g, device="cuda", dtype=torch.int64).to(torch.int32)
    rand_valid = lambda: torch.rand((4, k2), generator=g, device="cuda") > 0.2
    cases.append(("random K=2048", rand_desc(), rand_desc(), rand_valid(), rand_valid()))
    match_err = 0.0
    for label, da, db, va, vb in cases:
        ok_ = cuda_match.match_reductions_cuda(da, db, va, vb)
        pl_ = cuda_match.match_reductions_plain(da, db, va, vb)
        torch.cuda.synchronize()
        for name, a, b in zip(("i1", "col_best"), (ok_[1], ok_[3]), (pl_[1], pl_[3])):
            if not torch.equal(a, b):
                raise AssertionError(f"match {label}: {name} differs in {int((a != b).sum())} entries")
        for name, a, b in zip(("d1", "d2"), (ok_[0], ok_[2]), (pl_[0], pl_[2])):
            if not torch.equal(a, b):  # integer distances (or BIG): exact
                raise AssertionError(f"match {label}: {name} differs, max {float((a - b).abs().max())}")
        match_err = max(match_err, float((ok_[0] - pl_[0]).abs().max()), float((ok_[2] - pl_[2]).abs().max()))
        log(f"match_reductions {label} {tuple(da.shape)}: equal to plain")
    _, da, db, va, vb = cases[0]
    results["hamming_match"] = dict(
        max_abs_err=match_err,
        ms=median_ms(lambda: cuda_match.match_reductions_cuda(da, db, va, vb)),
        plain_ms=median_ms(lambda: cuda_match.match_reductions_plain(da, db, va, vb)),
        source="droplet_visual_odometry_tpu_torch/csrc/hamming_match.cu",
    )
    for name, r in results.items():
        log(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms at main-path shapes")
    return results


def phase_end_to_end(seq):
    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig, run_sequence
    from droplet_visual_odometry_tpu_torch.eval import tum
    from droplet_visual_odometry_tpu_torch.ops import cuda_fast, cuda_match, cuda_patches

    counters = (cuda_fast, cuda_patches, cuda_match)
    for mod in counters:
        mod.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        res = pipeline.run_experiment(seq, VOConfig(), out_dir, SEED, backend="none", device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = {"fast_score": cuda_fast.LAUNCHES, "extract_patches": cuda_patches.LAUNCHES,
                    "hamming_match": cuda_match.LAUNCHES}
        log(f"run_experiment (cold, incl. upload) {cold_s:.2f} s; kernel launches {launches}")
        n_levels = VOConfig().n_levels
        if launches["fast_score"] != n_levels or launches["extract_patches"] != n_levels:
            raise AssertionError(f"expected {n_levels} FAST and patch launches (one per level), got {launches}")
        if launches["hamming_match"] < 1:
            raise AssertionError("the match kernel never launched on the main path")

        n = len(seq)
        traj = res.trajectory
        if not (np.isfinite(res.vo_abs).all() and res.vo_abs.shape == (n, 4, 4)):
            raise AssertionError("non-finite or misshapen absolute poses")
        ok_frac = float(np.mean(traj.ok))
        if ok_frac < 0.9:
            raise AssertionError(f"only {ok_frac:.2f} of pairs ok")
        for name in tum.STREAM_NAMES:
            stamps, poses = tum.read_tum(os.path.join(out_dir, name))
            rows = n if name.endswith("absolute.txt") else n - 1
            if stamps.shape != (rows,) or not np.isfinite(poses).all():
                raise AssertionError(f"{name}: {stamps.shape} rows, finite={np.isfinite(poses).all()}")
    log(f"pairs ok {ok_frac:.3f}; n_matches {traj.n_matches.tolist()}; n_inliers {traj.n_inliers.tolist()}")
    log(f"ATE rmse {res.ate.rmse!r} m (JAX reference {JAX_ATE_RMSE} +- {ATE_TOL}); "
        f"RPE {res.rpe.trans_rmse!r} m / {res.rpe.rot_rmse_deg!r} deg")
    if abs(res.ate.rmse - JAX_ATE_RMSE) > ATE_TOL:
        raise AssertionError(f"ATE {res.ate.rmse} outside {JAX_ATE_RMSE} +- {ATE_TOL}")
    match_dev = np.abs(traj.n_matches - np.asarray(JAX_N_MATCHES)).sum() / np.sum(JAX_N_MATCHES)
    log(f"match counts vs JAX: {int((traj.n_matches == np.asarray(JAX_N_MATCHES)).sum())}/{n - 1} pairs equal, "
        f"total deviation {match_dev:.4f}")
    if match_dev > MATCH_TOL:
        raise AssertionError(f"match counts deviate {match_dev:.4f} from the JAX reference's")

    # Warm, synchronised throughput of run_sequence on device-resident frames.
    frames = pipeline.make_preprocessor(seq, "cuda")(seq.frames)
    K = pipeline.effective_K(seq)
    corners = pipeline.effective_marker_corners(seq, K)
    args = (frames, corners, seq.marker_present, seq.marker_poses[0], K, seq.real_marker_length, VOConfig())
    run_sequence(*args, seed=SEED)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        run_sequence(*args, seed=SEED)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    log(f"run_sequence warm: {dt * 1e3:.2f} ms per {n}-frame sequence = {(n - 1) / dt:.2f} frames/s "
        f"(pairs per second, bench.py's definition)")
    return launches


def wall_ms(fn, reps: int = 7) -> float:
    """Median synchronised host wall of fn() in ms."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def phase_profile(seq) -> dict:
    """Stage breakdown and device idle share of a warm run_sequence."""
    from torch.profiler import ProfilerActivity, profile

    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.estimation import scale as scale_mod
    from droplet_visual_odometry_tpu_torch.estimation.ransac import ransac_pose
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig, chain_poses, run_sequence
    from droplet_visual_odometry_tpu_torch.frontend import matcher
    from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch
    from droplet_visual_odometry_tpu_torch.frontend.orb import Features

    cfg = VOConfig()
    frames = pipeline.make_preprocessor(seq, "cuda")(seq.frames)
    K = pipeline.effective_K(seq)
    corners = pipeline.effective_marker_corners(seq, K)
    args = (frames, corners, seq.marker_present, seq.marker_poses[0], K, seq.real_marker_length, cfg)
    for _ in range(3):
        run_sequence(*args, seed=SEED)

    # The stages of run_sequence (vo.py), each on the outputs of the one before.
    Kt = torch.as_tensor(K, dtype=torch.float32, device="cuda")
    ct = torch.nan_to_num(torch.as_tensor(corners, dtype=torch.float32, device="cuda"))
    present = torch.as_tensor(seq.marker_present, device="cuda")
    feats = detect_and_describe_batch(frames, k=cfg.n_keypoints)
    fp, fc = Features(*(a[:-1] for a in feats)), Features(*(a[1:] for a in feats))
    m = matcher.match(fp.desc, fc.desc, fp.valid, fc.valid)
    p1, p2, valid = matcher.gather_correspondences(fp.xy, fc.xy, m)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    R, t, _ = ransac_pose(p1, p2, valid, Kt, cfg.ransac, g)
    rels = torch.eye(4, device="cuda").repeat(len(seq) - 1, 1, 1)
    stages = {
        "frontend": lambda: detect_and_describe_batch(frames, k=cfg.n_keypoints),
        "match": lambda: matcher.match(fp.desc, fc.desc, fp.valid, fc.valid),
        "ransac_pose": lambda: ransac_pose(p1, p2, valid, Kt, cfg.ransac, g),
        "scale": lambda: scale_mod.scale_factor_with_valid(
            Kt, R, t, ct[:-1], ct[1:], seq.real_marker_length, present[:-1] & present[1:]),
        "chain": lambda: chain_poses(torch.eye(4, device="cuda"), rels),
    }
    out = {"stage_ms": {name: wall_ms(fn) for name, fn in stages.items()}}
    out["run_sequence_ms"] = wall_ms(lambda: run_sequence(*args, seed=SEED))

    runs = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            run_sequence(*args, seed=SEED)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    if busy_us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    out.update(
        profiled_ms_per_run=window_s * 1e3 / runs,
        kernels_per_run=sum(e.count for e in dev) / runs,
        device_busy_ms_per_run=busy_us / 1e3 / runs,
        device_idle_share=1.0 - busy_us / 1e6 / window_s,
        top_kernels_ms_per_run=[
            [e.key[:80], e.count // runs, e.self_device_time_total / 1e3 / runs]
            for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]
        ],
        top_aten_ops_per_run=[
            [e.key, e.count // runs]
            for e in sorted((e for e in events if e.key.startswith("aten::")), key=lambda e: -e.count)[:12]
        ],
    )
    log(json.dumps({"profile": out}))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one GPU.")
    parser.add_argument("--profile", action="store_true", help="also run the stage breakdown and torch.profiler")
    opts = parser.parse_args()
    kind = phase_environment()
    seq = phase_data()
    kernels = phase_kernels(seq)
    launches = phase_end_to_end(seq)
    if opts.profile:
        phase_profile(seq)
    rows = [
        dict(name=name, route="cuda", source=r["source"], replaces=REPLACES[name], launches=launches[name],
             max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"])
        for name, r in kernels.items()
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
