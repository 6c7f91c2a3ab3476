#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases (any failure raises, so the exit code is non-zero):
  1. environment: require CUDA, print the card, build the kernels from csrc/;
  2. data: render the 24-frame 1440x1080 synthetic workload of bench.py;
  3. each kernel against its plain PyTorch twin on the card, at the shapes
     the main path gives it (FAST on the four pyramid levels, bit for bit;
     describe at each level's real keypoint origins, words equal and angle
     differences counted; match on the 23 real descriptor pairs plus a
     random K=2048 case), with kernel and plain device times from CUDA
     events (device_ms: L2 evicted, host overhead hidden; call_ms: one call
     with its launch), the describe row beside the old chain's f32 steering
     matmul alone, and each kernel's bound: the least time for its bytes at
     3.35 TB/s or its operations at the card's peak rate, counted from this
     run's inputs. The match row also carries its bound at the popcount
     rate (for reference), the time of the bf16 matmul of its +-1 operands
     (the distance product alone, no reduction; the port never calls it),
     the time of a launch that does nothing (the floor of that timing),
     and a sweep at P=23 over K = 512, 1024, 2048 plus P=64 at K=512, each
     point exact against the plain twin;
  4. the port's main path, pipeline.run_experiment(backend="none",
     device="cuda"), with every kernel's launch counter checked (FAST and
     describe once per pyramid level, match at least once), the poses,
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
    "orb_describe": "droplet_visual_odometry_tpu/ops/pallas_patches.py:103",
    "hamming_match": "droplet_visual_odometry_tpu/ops/pallas_match.py:105",
}

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes/s,
# f32 operations/s outside the tensor cores, dense int8 tensor-core
# operations/s, and 32-bit popcounts per clock per SM (16 on sm_90) over its
# 132 SMs.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
POPC_PER_CLOCK_PER_SM = 16
N_SMS = 132

# Operations FAST does per pixel (csrc/fast_score.cu): every interior pixel
# runs the compass pre-test (centre +- threshold, 8 compares); a pixel that
# passes runs the ring (16 x: sub, abs, sub, 2 compares, 2 adds) and the max.
FAST_PRETEST_OPS = 10
FAST_RING_OPS = 16 * 7 + 1

# Kernel timing (device_ms): the bytes written to evict the L2 before each
# timed call, and the spin before it (about 2 ms at 1.98 GHz), longer than
# the host takes to enqueue any timed call of this script.
FLUSH_BYTES = 128 * 2**20
SPIN_CYCLES = 4_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of one fn() in ms, from CUDA events around it.

    Before each timed call a spin kernel holds the card while the host
    enqueues the call, so the host's launch overhead is not counted, and a
    write of FLUSH_BYTES evicts the 50 MB L2, as the main path finds each
    input cold (an earlier stage wrote it, and a level-0 image is 149 MB)."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def call_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median time of one fn() in ms between CUDA events recorded from an
    idle card, so the host's launch overhead is included."""
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


def bound(bytes_moved: float, ops: float, ops_per_s: float) -> tuple[float, str, float, float]:
    """(bound ms, what bounds it, bytes ms, operations ms)."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), bytes_ms, ops_ms


def sm_clocks_mhz() -> tuple[float, float]:
    """(current, maximum) SM clock of card 0 from nvidia-smi, in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    cur, top = (float(v) for v in out.split(","))
    return cur, top


def fast_candidates(level: torch.Tensor, threshold: float, arc: int) -> tuple[int, int]:
    """(interior pixels, pixels that pass FAST's compass pre-test) of a level."""
    from droplet_visual_odometry_tpu_torch.ops import cuda_fast

    n, h, w = level.shape
    c = level[:, 3:-3, 3:-3]
    nb = torch.zeros_like(c, dtype=torch.int32)
    nd = torch.zeros_like(c, dtype=torch.int32)
    for j in cuda_fast.COMPASS:
        dy, dx = cuda_fast.CIRCLE_OFFSETS[j]
        v = level[:, 3 + dy : h - 3 + dy, 3 + dx : w - 3 + dx]
        nb += (v > c + threshold).to(torch.int32)
        nd += (v < c - threshold).to(torch.int32)
    need = cuda_fast.compass_need(arc)
    return c.numel(), int(((nb >= need) | (nd >= need)).sum())


def match_bound(p: int, k: int) -> tuple[float, str, float, float]:
    """Bound of the match reductions of P pairs of K descriptors: both sets
    and masks read, four (P, K) 4-byte outputs written; 2*K*K*256
    operations a pair (the 256-bit product popc(a & b) of every row with
    every column) at the int8 tensor-core rate: the data sheet gives no
    binary rate."""
    return bound(2 * p * k * 32 + 2 * p * k + 4 * p * k * 4, 2.0 * p * k * k * 256, INT8_OPS_PER_S)


def check_match(label: str, da, db, va, vb) -> float:
    """Raise unless the match kernel equals its plain twin exactly; the max abs error (0)."""
    from droplet_visual_odometry_tpu_torch.ops import cuda_match

    got = cuda_match.match_reductions_cuda(da, db, va, vb)
    want = cuda_match.match_reductions_plain(da, db, va, vb)
    torch.cuda.synchronize()
    for name, a, b in zip(("d1", "i1", "d2", "col_best"), got, want):
        if not torch.equal(a, b):  # integer distances (or BIG) and indices: exact
            raise AssertionError(f"match {label}: {name} differs in {int((a != b).sum())} entries")
    log(f"match_reductions {label} {tuple(da.shape)}: equal to plain")
    return max(float((got[0] - want[0]).abs().max()), float((got[2] - want[2]).abs().max()))


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
    log(build.last_ptxas_report)
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
    from droplet_visual_odometry_tpu_torch.ops import cuda_describe, cuda_fast, cuda_match

    frames = torch.as_tensor(seq.frames).cuda().float()
    n, h0, w0 = frames.shape
    k = 512
    shapes = features.level_shapes(h0, w0, features.N_LEVELS, features.SCALE_FACTOR)
    budgets = features.level_budgets(k, features.N_LEVELS, features.SCALE_FACTOR)
    zero = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0, max_abs_err=0.0)
    fast_r = dict(zero, source="droplet_visual_odometry_tpu_torch/csrc/fast_score.cu", bound_by="bytes")
    desc_r = dict(zero, source="droplet_visual_odometry_tpu_torch/csrc/orb_describe.cu", bound_by="bytes",
                  steer_matmul_ms=0.0, angles_differ=0, patch_mb=0.0)

    # Kernel 1: FAST on every pyramid level; kernel 2: describe at the level's real origins.
    level = frames
    for l, (lh, lw) in enumerate(shapes):
        if l > 0:
            level = filters.resize_bilinear(level, lh, lw).contiguous()
        out_k = cuda_fast.fast_score_cuda(level, 20.0, 9)
        out_p = cuda_fast.fast_score_plain(level, 20.0, 9)
        torch.cuda.synchronize()
        if not torch.equal(out_k, out_p):  # the same f32 ops in the same neighbour order
            raise AssertionError(f"FAST level {l}: {int((out_k != out_p).sum())} px differ from plain, "
                                 f"max {float((out_k - out_p).abs().max())}")
        interior, passed = fast_candidates(level, 20.0, 9)
        b_ms, _, by_ms, op_ms = bound(8.0 * level.numel(), interior * FAST_PRETEST_OPS + passed * FAST_RING_OPS,
                                      F32_OPS_PER_S)
        ms = device_ms(lambda: cuda_fast.fast_score_cuda(level, 20.0, 9))
        fast_r["ms"] += ms
        fast_r["call_ms"] += call_ms(lambda: cuda_fast.fast_score_cuda(level, 20.0, 9))
        fast_r["plain_ms"] += device_ms(lambda: cuda_fast.fast_score_plain(level, 20.0, 9), reps=3, warmup=1)
        fast_r["bound_ms"] += b_ms
        fast_r["bytes_ms"] += by_ms
        fast_r["ops_ms"] += op_ms
        log(f"fast_score level {l} {tuple(level.shape)}: equal to plain; corners {int((out_k > 0).sum())}; "
            f"compass pre-test passes {passed} of {interior} interior px ({passed / interior:.4f}); "
            f"kernel {ms:.4f} ms, bound {b_ms:.4f} ms")

        kps = fast.select_topk_rows(fast.nms3x3(out_k), budgets[l])
        blur = filters.gaussian_blur(level, 2.0, 4, compute_dtype=torch.bfloat16).contiguous()
        origins = patch_origins(kps.xy, lh, lw)
        m = origins.shape[0]
        dk, ak = cuda_describe.describe_cuda(blur, origins, check=True)
        dp, ap = cuda_describe.describe_plain(blur, origins)
        torch.cuda.synchronize()
        if not torch.equal(dk, dp):
            raise AssertionError(f"describe level {l}: {int((dk != dp).any(-1).sum())} of {m} descriptors differ")
        two_pi = torch.full_like(ap, 2.0 * np.pi)
        bins_k = torch.remainder(torch.round(ak / two_pi * 30), 30)
        bins_p = torch.remainder(torch.round(ap / two_pi * 30), 30)
        if not torch.equal(bins_k, bins_p):
            raise AssertionError(f"describe level {l}: {int((bins_k != bins_p).sum())} angle bins differ")
        differ = int((ak != ap).sum())
        desc_r["angles_differ"] += differ
        desc_r["max_abs_err"] = max(desc_r["max_abs_err"], float((ak - ap).abs().max()))
        # The least bytes: each distinct pixel under a patch read once, the
        # origins and the (30, 256, 2) int16 pair table read, 36 B written per keypoint.
        covered = torch.zeros(level.shape, dtype=torch.bool, device="cuda")
        r = torch.arange(cuda_describe.PATCH, device="cuda")
        o = origins.long()
        covered[o[:, 0, None, None], (o[:, 1, None] + r)[:, :, None], (o[:, 2, None] + r)[:, None, :]] = True
        desc_bytes = 4.0 * int(covered.sum()) + 12.0 * m + cuda_describe._PAIRS.nbytes + 36.0 * m
        b_ms, _, by_ms, op_ms = bound(desc_bytes, m * (2 * 2 * 1017 + 2 * 256), F32_OPS_PER_S)
        q = torch.round(cuda_describe.extract_patches_plain(blur, origins).reshape(m, -1))
        steer = cuda_describe._steer_w(q.device)
        ms = device_ms(lambda: cuda_describe.describe_cuda(blur, origins))
        desc_r["ms"] += ms
        desc_r["call_ms"] += call_ms(lambda: cuda_describe.describe_cuda(blur, origins))
        desc_r["plain_ms"] += device_ms(lambda: cuda_describe.describe_plain(blur, origins))
        desc_r["steer_matmul_ms"] += device_ms(lambda: q @ steer)
        desc_r["bound_ms"] += b_ms
        desc_r["bytes_ms"] += by_ms
        desc_r["ops_ms"] += op_ms
        desc_r["patch_mb"] += m * cuda_describe.PATCH**2 * 4 / 1e6
        log(f"orb_describe level {l}: {m} keypoints, words equal to plain, {differ} angles differ "
            f"(max {float((ak - ap).abs().max())}), no bin differs; kernel {ms:.4f} ms, bound {b_ms:.4f} ms")

    # Kernel 3: the 23 real descriptor pairs at K=512, plus random sets with invalid masks.
    feats = features.detect_and_describe_batch(frames, k=k)
    da, db = feats.desc[:-1].contiguous(), feats.desc[1:].contiguous()
    va, vb = feats.valid[:-1].contiguous(), feats.valid[1:].contiguous()
    g = torch.Generator(device="cuda").manual_seed(1)

    def rand_case(pp, kk):
        desc = lambda: torch.randint(-2**31, 2**31 - 1, (pp, kk, 8), generator=g, device="cuda",
                                     dtype=torch.int64).to(torch.int32)
        valid = lambda: torch.rand((pp, kk), generator=g, device="cuda") > 0.2
        return desc(), desc(), valid(), valid()

    match_err = max(check_match("real K=512", da, db, va, vb), check_match("random K=2048", *rand_case(4, 2048)))
    p, km = da.shape[0], da.shape[1]
    clock_now, clock_max = sm_clocks_mhz()
    b_ms, by, by_ms, op_ms = match_bound(p, km)
    # The same distances as 32-bit XOR + popcount pairs at 16 popcounts per clock per SM.
    popc_ms = p * km * km * 8 / (POPC_PER_CLOCK_PER_SM * N_SMS * clock_max * 1e6) * 1e3
    a_pm1 = cuda_match.unpack_bits_pm1(da, torch.bfloat16)
    bt_pm1 = cuda_match.unpack_bits_pm1(db, torch.bfloat16).transpose(-1, -2).contiguous()
    matmul_ms = device_ms(lambda: torch.matmul(a_pm1, bt_pm1))
    tiny = torch.empty(1, device="cuda")
    floor_ms = device_ms(lambda: tiny.zero_())  # one launch doing nothing: the floor of device_ms
    sweep = []
    for sp, sk in ((23, 512), (23, 1024), (23, 2048), (64, 512)):
        case = rand_case(sp, sk)
        check_match(f"sweep P={sp} K={sk}", *case)
        s_ms = device_ms(lambda: cuda_match.match_reductions_cuda(*case))
        s_bound = match_bound(sp, sk)[0]
        sweep.append(dict(p=sp, k=sk, ms=s_ms, bound_ms=s_bound, share=s_bound / s_ms))
        log(f"match sweep P={sp} K={sk}: kernel {s_ms:.4f} ms, int8 bound {s_bound:.4f} ms ({s_bound / s_ms:.3f})")
    results = {
        "fast_score": fast_r,
        "orb_describe": desc_r,
        "hamming_match": dict(
            max_abs_err=match_err,
            ms=device_ms(lambda: cuda_match.match_reductions_cuda(da, db, va, vb)),
            call_ms=call_ms(lambda: cuda_match.match_reductions_cuda(da, db, va, vb)),
            plain_ms=device_ms(lambda: cuda_match.match_reductions_plain(da, db, va, vb)),
            bound_ms=b_ms, bound_by=by, bytes_ms=by_ms, ops_ms=op_ms, popc_bound_ms=popc_ms,
            matmul_ms=matmul_ms, empty_launch_ms=floor_ms, k_sweep=sweep,
            sm_clock_mhz=clock_now, sm_clock_max_mhz=clock_max,
            source="droplet_visual_odometry_tpu_torch/csrc/hamming_match.cu",
        ),
    }
    for name, r in results.items():
        log(f"{name}: kernel {r['ms']:.4f} ms (one call with its launch {r['call_ms']:.4f} ms), "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; bytes {r['bytes_ms']:.4f} ms, operations {r['ops_ms']:.4f} ms) at main-path shapes")
    log(f"hamming_match: bound at the popcount rate {popc_ms:.4f} ms; bf16 matmul of the +-1 operands "
        f"alone {matmul_ms:.4f} ms; a one-element zero_() under the same timing {floor_ms:.4f} ms")
    log(f"orb_describe vs the old chain's f32 steering matmul alone: {desc_r['ms']:.4f} ms vs "
        f"{desc_r['steer_matmul_ms']:.4f} ms; patches {desc_r['patch_mb']:.1f} MB")
    return results


def phase_end_to_end(seq):
    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig, run_sequence
    from droplet_visual_odometry_tpu_torch.eval import tum
    from droplet_visual_odometry_tpu_torch.ops import cuda_describe, cuda_fast, cuda_match

    counters = (cuda_fast, cuda_describe, cuda_match)
    for mod in counters:
        mod.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        res = pipeline.run_experiment(seq, VOConfig(), out_dir, SEED, backend="none", device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = {"fast_score": cuda_fast.LAUNCHES, "orb_describe": cuda_describe.LAUNCHES,
                    "hamming_match": cuda_match.LAUNCHES}
        log(f"run_experiment (cold, incl. upload) {cold_s:.2f} s; kernel launches {launches}")
        n_levels = VOConfig().n_levels
        if launches["fast_score"] != n_levels or launches["orb_describe"] != n_levels:
            raise AssertionError(f"expected {n_levels} FAST and describe launches (one per level), got {launches}")
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
    # One run of the main path is one run_sequence, so its launches are the launches per run.
    rows = [
        dict(r, name=name, route="cuda", replaces=REPLACES[name], launches=launches[name],
             launches_per_run=launches[name], library_ms=None)
        for name, r in kernels.items()
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
