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
  5. the shipped default, run_experiment(backend="pose_graph") with
     VOConfig(scale_mode="hold") and the default PoseGraphRefineConfig, on
     a 48-frame 1440x1080 loop whose marker shows on its first and last 8
     frames only: launch counters (FAST and describe once per level on the
     frames and again on the keyframe stack, the match at least 3 times),
     the bridge pair and loop edges, the graph cost, poses and TUM files,
     the ATE against the JAX package's; then the kernels at the new shapes
     (FAST and describe on the keyframe stack at k=1024, the match on the
     real retrieval and verification sets at K=1024, each exact against its
     twin and timed beside its bound), the PCG loop's two forms (the stop
     test on the device vs read on the host each step) timed on the run's
     graph, and the warm wall of pose_graph_trajectory;
  6. with --profile only: each stage of run_sequence and of
     pose_graph_trajectory timed alone (host clock, synchronised, median of
     7) and torch.profiler over warm runs of each (CUDA kernels per run,
     device busy ms, device idle share, the top kernels by device time and,
     for run_sequence, the top aten ops by count), printed as one JSON line
     {"profile": {...}}.
Then one JSON line with the per-kernel results (`launches` from phase 5's
run, `launches_by_path` from phases 4 and 5), and last the line
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

# The pose-graph phase's sequence (a loop at the bench workload's size; its
# marker kept on the first and last 8 frames, as tests/test_loop_closure.py
# does at 448x336) and the JAX package's figures on it, from
#   JAX_PLATFORMS=cpu python tools/jax_pose_graph_figures.py --seeds 0 1 2 3
# run on a CPU: run_experiment(backend="pose_graph") with
# VOConfig(scale_mode="hold") and the default PoseGraphRefineConfig gives ATE
# RMSE (m) 0.030605 / 0.035646 / 0.061291 / 0.086198 over RANSAC seeds 0-3,
# one bridge pair and 9 / 3 / 4 / 4 loop edges. As in phase 4 the port's ATE
# is held to seed 0's value within twice the reference's own seed-to-seed
# spread around it (0.055593 m).
LOOP_SEQ_CONFIG = dict(SEQ_CONFIG, n_frames=48, orbit_sweep=0.6, dolly=0.5, loop=True, noise_std=1.5)
MARKER_KEEP = 8
JAX_PG_ATE_RMSE = 0.030605
PG_ATE_TOL = 0.111
JAX_PG_BRIDGE_PAIRS = 1

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


def frontend_levels(frames: torch.Tensor, k: int, label: str) -> tuple[dict, dict]:
    """FAST (kernel 1) on every pyramid level of `frames` and describe
    (kernel 2) at each level's real keypoint origins for a budget of k, each
    held against its plain twin (FAST and the descriptor words bit for bit,
    no angle bin differing) and timed beside its bound; per-level figures
    summed into one row per kernel."""
    from droplet_visual_odometry_tpu_torch.frontend import fast, features, filters
    from droplet_visual_odometry_tpu_torch.frontend.orb import patch_origins
    from droplet_visual_odometry_tpu_torch.ops import cuda_describe, cuda_fast

    n, h0, w0 = frames.shape
    shapes = features.level_shapes(h0, w0, features.N_LEVELS, features.SCALE_FACTOR)
    budgets = features.level_budgets(k, features.N_LEVELS, features.SCALE_FACTOR)
    zero = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0, max_abs_err=0.0)
    fast_r = dict(zero, source="droplet_visual_odometry_tpu_torch/csrc/fast_score.cu", bound_by="bytes")
    desc_r = dict(zero, source="droplet_visual_odometry_tpu_torch/csrc/orb_describe.cu", bound_by="bytes",
                  steer_matmul_ms=0.0, angles_differ=0, patch_mb=0.0)
    level = frames
    for l, (lh, lw) in enumerate(shapes):
        if l > 0:
            level = filters.resize_bilinear(level, lh, lw).contiguous()
        out_k = cuda_fast.fast_score_cuda(level, 20.0, 9)
        out_p = cuda_fast.fast_score_plain(level, 20.0, 9)
        torch.cuda.synchronize()
        if not torch.equal(out_k, out_p):  # the same f32 ops in the same neighbour order
            raise AssertionError(f"FAST {label} level {l}: {int((out_k != out_p).sum())} px differ from plain, "
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
        log(f"fast_score {label} level {l} {tuple(level.shape)}: equal to plain; corners {int((out_k > 0).sum())}; "
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
            raise AssertionError(f"describe {label} level {l}: {int((dk != dp).any(-1).sum())} of {m} descriptors differ")
        two_pi = torch.full_like(ap, 2.0 * np.pi)
        bins_k = torch.remainder(torch.round(ak / two_pi * 30), 30)
        bins_p = torch.remainder(torch.round(ap / two_pi * 30), 30)
        if not torch.equal(bins_k, bins_p):
            raise AssertionError(f"describe {label} level {l}: {int((bins_k != bins_p).sum())} angle bins differ")
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
        log(f"orb_describe {label} level {l}: {m} keypoints, words equal to plain, {differ} angles differ "
            f"(max {float((ak - ap).abs().max())}), no bin differs; kernel {ms:.4f} ms, bound {b_ms:.4f} ms")
    return fast_r, desc_r


def match_case(label: str, da, db, va, vb) -> dict:
    """The match kernel on one set of pairs: exact against its plain twin,
    timed beside its int8-rate bound."""
    from droplet_visual_odometry_tpu_torch.ops import cuda_match

    args = [t.contiguous() for t in (da, db, va, vb)]
    err = check_match(label, *args)
    p, k = args[0].shape[0], args[0].shape[1]
    ms = device_ms(lambda: cuda_match.match_reductions_cuda(*args))
    b_ms = match_bound(p, k)[0]
    log(f"match {label} P={p} K={k}: kernel {ms:.4f} ms, int8 bound {b_ms:.4f} ms ({b_ms / ms:.3f})")
    return dict(p=p, k=k, ms=ms, bound_ms=b_ms, share=b_ms / ms, max_abs_err=err)


def phase_kernels(seq):
    from droplet_visual_odometry_tpu_torch.frontend import features
    from droplet_visual_odometry_tpu_torch.ops import cuda_match

    frames = torch.as_tensor(seq.frames).cuda().float()
    k = 512
    fast_r, desc_r = frontend_levels(frames, k, "main path")

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


def phase_loop_data():
    """The pose-graph phase's sequence: the 48-frame 1440x1080 out-and-back
    loop with the marker kept on its first and last 8 frames only."""
    from droplet_visual_odometry_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    seq = synthetic.render_sequence(synthetic.SyntheticConfig(**LOOP_SEQ_CONFIG))
    seq.marker_present[MARKER_KEEP:-MARKER_KEEP] = False
    seq.marker_corners[MARKER_KEEP:-MARKER_KEEP] = np.nan
    log(f"rendered the loop sequence {seq.frames.shape} in {time.perf_counter() - t0:.1f} s; marker on "
        f"{int(seq.marker_present.sum())} frames")
    return seq


def pcg_host_stop(matvec, b, Minv, iters: int, tol: float) -> torch.Tensor:
    """The reference's PCG loop (pose_graph.py:143-172) with its stop test
    read on the host every step: the other form of backend/pose_graph._pcg,
    which issues all iters steps and sets the step length to 0 on the
    device once the test fails. Counts its steps in PCG_STEPS."""
    apply_minv = lambda r: torch.einsum("mab,mb->ma", Minv, r)
    x, r = torch.zeros_like(b), b
    z = apply_minv(r)
    p = z
    stop = tol * torch.clamp(torch.sum(b * b), min=1e-30)
    k = 0
    while k < iters and bool(torch.sum(r * r) > stop):
        Hp = matvec(p)
        rz = torch.sum(r * z)
        alpha = rz / torch.clamp(torch.sum(p * Hp), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        z_new = apply_minv(r)
        beta = torch.sum(r * z_new) / torch.clamp(rz, min=1e-30)
        p = z_new + beta * p
        z = z_new
        k += 1
    PCG_STEPS.append(k)
    return x


PCG_STEPS: list[int] = []


def loop_inputs(seq, res, cfg):
    """The pose-graph path's intermediate inputs, rebuilt from a run's VO
    outputs exactly as backend/refine.pose_graph_trajectory builds them."""
    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.backend import refine

    frames = pipeline.make_preprocessor(seq, "cuda")(seq.frames)
    K = pipeline.effective_K(seq).astype(np.float32)
    corners = pipeline.effective_marker_corners(seq, K)
    traj = res.trajectory
    if not seq.marker_present[0]:
        raise AssertionError("the loop sequence must carry the marker on frame 0 (no re-anchoring)")
    vo_abs = np.asarray(traj.abs_poses, np.float64)
    kf_idx = refine.keyframe_indices(vo_abs, traj.n_inliers, seq.marker_present, cfg.kf)
    if len(kf_idx) != res.backend_info["n_keyframes"]:
        raise AssertionError(f"{len(kf_idx)} keyframes rebuilt, the run had {res.backend_info['n_keyframes']}")
    bridges = refine.bridge_pairs(seq.marker_present, kf_idx)
    kf_frames = frames[torch.as_tensor(kf_idx, device="cuda")]
    return dict(frames=frames, K=K, corners=corners, traj=traj, vo_abs=vo_abs, kf_idx=kf_idx, kf_frames=kf_frames,
                extra=tuple(np.asarray(b) for b in bridges), lc=cfg.lc, cfg=cfg,
                L=seq.real_marker_length, n_kf=len(kf_idx))


def phase_pose_graph(seq, results) -> dict:
    """The shipped default, run_experiment(backend="pose_graph") with
    VOConfig(scale_mode="hold") and the default PoseGraphRefineConfig:
    launch counters, structure, ATE against the JAX package's; then the
    kernels at the path's new shapes (FAST and describe on the keyframe
    stack at k=1024, the match on the real retrieval and verification
    sets), the PCG loop's two forms, and the warm wall."""
    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.backend import loop_closure, pose_graph, refine
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu_torch.eval import tum
    from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch
    from droplet_visual_odometry_tpu_torch.ops import cuda_describe, cuda_fast, cuda_match

    vo, cfg = VOConfig(scale_mode="hold"), refine.PoseGraphRefineConfig()
    for mod in (cuda_fast, cuda_describe, cuda_match):
        mod.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        res = pipeline.run_experiment(seq, vo, out_dir, SEED, backend="pose_graph", device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = {"fast_score": cuda_fast.LAUNCHES, "orb_describe": cuda_describe.LAUNCHES,
                    "hamming_match": cuda_match.LAUNCHES}
        info = res.backend_info
        log(f"run_experiment(backend='pose_graph') (cold, incl. upload) {cold_s:.2f} s; kernel launches {launches}")
        log(f"backend info {json.dumps(info)}")
        n_levels = vo.n_levels
        if launches["fast_score"] != 2 * n_levels or launches["orb_describe"] != 2 * n_levels:
            raise AssertionError(f"expected {2 * n_levels} FAST and describe launches (VO frames and the keyframe "
                                 f"stack, one per level each), got {launches}")
        if launches["hamming_match"] < 3:
            raise AssertionError(f"expected >= 3 match launches (VO, retrieval, verification), got {launches}")
        n = len(seq)
        if not (np.isfinite(res.vo_abs).all() and res.vo_abs.shape == (n, 4, 4)):
            raise AssertionError("non-finite or misshapen absolute poses")
        for name in tum.STREAM_NAMES:
            stamps, poses = tum.read_tum(os.path.join(out_dir, name))
            rows = n if name.endswith("absolute.txt") else n - 1
            if stamps.shape != (rows,) or not np.isfinite(poses).all():
                raise AssertionError(f"{name}: {stamps.shape} rows, finite={np.isfinite(poses).all()}")
    if info["n_bridge_pairs"] != JAX_PG_BRIDGE_PAIRS:
        raise AssertionError(f"{info['n_bridge_pairs']} bridge pairs, the JAX package has {JAX_PG_BRIDGE_PAIRS}")
    if info["n_loop_edges"] < 1:
        raise AssertionError("no loop edge, where the JAX package finds 3-9 over seeds 0-3")
    if not info["pg_final_cost"] < info["pg_initial_cost"]:
        raise AssertionError(f"pose-graph cost did not fall: {info['pg_initial_cost']} -> {info['pg_final_cost']}")
    log(f"pose_graph ATE rmse {res.ate.rmse!r} m (JAX package {JAX_PG_ATE_RMSE} +- {PG_ATE_TOL}); "
        f"RPE {res.rpe.trans_rmse!r} m / {res.rpe.rot_rmse_deg!r} deg")
    if abs(res.ate.rmse - JAX_PG_ATE_RMSE) > PG_ATE_TOL:
        raise AssertionError(f"pose_graph ATE {res.ate.rmse} outside {JAX_PG_ATE_RMSE} +- {PG_ATE_TOL}")

    d = loop_inputs(seq, res, cfg)
    lc = d["lc"]
    fast_kf, desc_kf = frontend_levels(d["kf_frames"], cfg.n_keypoints, "keyframe stack")
    feats = detect_and_describe_batch(d["kf_frames"], k=cfg.n_keypoints, threshold=cfg.fast_threshold)
    ia, ib = loop_closure._shortlist_pairs(feats, d["n_kf"], lc.min_gap, lc.shortlist)
    if len(ia) != lc.shortlist:
        raise AssertionError(f"{len(ia)} retrieval pairs: the global tier did not run")
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device="cuda")
    retrieval = match_case("retrieval", feats.desc[idx(ia)], feats.desc[idx(ib)], feats.valid[idx(ia)],
                           feats.valid[idx(ib)])
    ca, cb, _ = loop_closure._candidate_pairs(feats, d["n_kf"], lc, d["extra"])
    R = max(1, lc.verify_restarts)
    ca_p, cb_p = loop_closure._restart_layout(ca, cb, loop_closure.verify_slots(len(ca), lc), R)
    verification = match_case("verification", feats.desc[idx(ca_p)], feats.desc[idx(cb_p)], feats.valid[idx(ca_p)],
                              feats.valid[idx(cb_p)])
    results["fast_score"]["keyframe_stack"] = {k: fast_kf[k] for k in ("ms", "plain_ms", "bound_ms")}
    results["orb_describe"]["keyframe_stack"] = {k: desc_kf[k] for k in ("ms", "plain_ms", "bound_ms")}
    results["hamming_match"]["loop_closure"] = {"retrieval": retrieval, "verification": verification}

    # The PCG loop's two forms on this run's graph.
    edges = loop_closure.find_loop_closures(
        feats, d["vo_abs"][d["kf_idx"]], d["corners"][d["kf_idx"]], seq.marker_present[d["kf_idx"]], d["K"], d["L"],
        vo, lc, extra_pairs=d["extra"])
    graph = refine.loop_graph(d["vo_abs"][d["kf_idx"]], d["kf_idx"], edges, d["traj"].n_inliers, cfg,
                              d["traj"].scale_ok, "cuda")
    m = int(graph.poses.shape[0])
    graph = pose_graph.pad_graph(graph, pose_graph.next_bucket(m), pose_graph.next_bucket(int(graph.edge_i.shape[0])))
    forms = {"device": pose_graph._pcg, "host": pcg_host_stop}

    def run_form(name, fn):
        pose_graph._pcg = forms[name]
        try:
            return fn()
        finally:
            pose_graph._pcg = forms["device"]

    device_stop = run_form("device", lambda: pose_graph.optimize(graph, cfg.pg))
    PCG_STEPS.clear()
    host_stop = run_form("host", lambda: pose_graph.optimize(graph, cfg.pg))
    steps = list(PCG_STEPS)
    # In turns (device, host, host, device), each turn the median of 3 calls.
    turns = {"device": [], "host": []}
    for name in ("device", "host", "host", "device"):
        turns[name].append(run_form(name, lambda: wall_ms(lambda: pose_graph.optimize(graph, cfg.pg), reps=3)))
    device_ms_, host_ms = float(np.mean(turns["device"])), float(np.mean(turns["host"]))
    cost_dev, cost_host = float(device_stop.final_cost), float(host_stop.final_cost)
    pose_dev = float((device_stop.poses - host_stop.poses).abs().max())
    log(f"PCG optimize on a graph of {m} nodes, {len(edges.i)} loop edges (padded to {tuple(graph.poses.shape)[0]} "
        f"nodes, {graph.edge_i.shape[0]} edges), {cfg.pg.iters} GN steps: device-side stop ({cfg.pg.cg_iters} CG "
        f"steps issued) {device_ms_:.2f} ms (turns {turns['device']}), host-read stop {host_ms:.2f} ms (turns "
        f"{turns['host']}; CG steps per GN step {steps}); "
        f"final cost {cost_dev!r} vs {cost_host!r}, poses differ by {pose_dev:.2e}")
    if abs(cost_dev - cost_host) > 1e-3 * abs(cost_host) or pose_dev > 1e-4:
        raise AssertionError("the two PCG forms disagree")

    args = (d["frames"], d["vo_abs"], d["traj"].n_inliers, d["corners"], seq.marker_present, d["K"], d["L"], vo, cfg)
    kw = dict(pair_scale_ok=d["traj"].scale_ok)
    warm_ms = wall_ms(lambda: refine.pose_graph_trajectory(*args, **kw), reps=3)
    log(f"pose_graph_trajectory warm: {warm_ms:.2f} ms over {d['n_kf']} keyframes of {len(seq)} frames")
    return dict(launches=launches, ate_rmse=res.ate.rmse, info=info, cold_s=cold_s, warm_ms=warm_ms,
                pcg=dict(device_stop_ms=device_ms_, host_stop_ms=host_ms, turns_ms=turns, cg_steps=steps, nodes=m,
                         padded_nodes=int(graph.poses.shape[0]), padded_edges=int(graph.edge_i.shape[0])),
                inputs=d, feats=feats, graph=graph, edges=edges)


def profile_pose_graph(seq, pg: dict) -> dict:
    """Each stage of backend/refine.pose_graph_trajectory timed alone on the
    loop run's inputs (host clock, synchronised, median of 7), and
    torch.profiler over two warm calls."""
    from torch.profiler import ProfilerActivity, profile

    from droplet_visual_odometry_tpu_torch.backend import loop_closure, pose_graph, refine
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig, VOStepResult
    from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch

    d, feats, cfg = pg["inputs"], pg["feats"], pg["inputs"]["cfg"]
    lc, vo = cfg.lc, VOConfig(scale_mode="hold")
    kf = d["kf_idx"]
    ia, ib = loop_closure._shortlist_pairs(feats, d["n_kf"], lc.min_gap, lc.shortlist)
    counts = loop_closure._retrieval_counts(feats.desc, feats.valid, ia, ib, lc.match_max_distance).cpu().numpy()
    ca, cb, _ = loop_closure._candidate_pairs(feats, d["n_kf"], lc, d["extra"])
    R, n_slot = max(1, lc.verify_restarts), loop_closure.verify_slots(len(ca), lc)
    ca_p, cb_p = loop_closure._restart_layout(ca, cb, n_slot, R)
    corners = torch.nan_to_num(torch.as_tensor(d["corners"][kf], device="cuda"))
    mvalid = torch.as_tensor(seq.marker_present[kf], device="cuda")
    Kt = torch.as_tensor(d["K"], device="cuda")
    vcfg = loop_closure._verify_vo_config(vo, lc)
    gen = torch.Generator(device="cuda").manual_seed(0)
    verify = lambda: loop_closure._verify_candidates(feats, corners, mvalid, Kt, d["L"], vcfg, ca_p, cb_p, gen)
    res = VOStepResult(*(t.cpu().numpy().reshape((R, n_slot) + tuple(t.shape[1:])) for t in verify()))
    refined_kf = np.linalg.inv(pose_graph.optimize(pg["graph"], cfg.pg).poses[: d["n_kf"]].cpu().numpy()
                               .astype(np.float64))
    stages = {
        "keyframe_frontend": lambda: detect_and_describe_batch(d["kf_frames"], k=cfg.n_keypoints,
                                                               threshold=cfg.fast_threshold),
        "global_retrieval": lambda: loop_closure._shortlist_pairs(feats, d["n_kf"], lc.min_gap, lc.shortlist),
        "retrieval_counts": lambda: loop_closure._retrieval_counts(feats.desc, feats.valid, ia, ib,
                                                                   lc.match_max_distance),
        "verification": verify,
        "host_selection": lambda: (loop_closure._select_candidates(ia, ib, counts, lc),
                                   loop_closure._pick_restarts(res, R, n_slot)),
        "pcg_optimize": lambda: pose_graph.optimize(pg["graph"], cfg.pg),
        "reanchor": lambda: refine.reanchor_segments(d["vo_abs"], kf, refined_kf),
    }
    out = {"stage_ms": {name: wall_ms(fn) for name, fn in stages.items()}}
    args = (d["frames"], d["vo_abs"], d["traj"].n_inliers, d["corners"], seq.marker_present, d["K"], d["L"], vo, cfg)
    call = lambda: refine.pose_graph_trajectory(*args, pair_scale_ok=d["traj"].scale_ok)
    out["pose_graph_trajectory_ms"] = wall_ms(call, reps=3)
    runs = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            call()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
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
            for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]
        ],
    )
    return out


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
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one GPU.")
    parser.add_argument("--profile", action="store_true", help="also run the stage breakdown and torch.profiler")
    opts = parser.parse_args()
    kind = phase_environment()
    seq = phase_data()
    kernels = phase_kernels(seq)
    launches_none = phase_end_to_end(seq)
    loop_seq = phase_loop_data()
    pg = phase_pose_graph(loop_seq, kernels)
    if opts.profile:
        prof = phase_profile(seq)
        prof["pose_graph"] = profile_pose_graph(loop_seq, pg)
        log(json.dumps({"profile": prof}))
    # `launches` counts the shipped default's run (run_experiment(backend="pose_graph"): VO, then the
    # keyframe stack, retrieval and verification); launches_by_path gives each path's own run.
    rows = [
        dict(r, name=name, route="cuda", replaces=REPLACES[name], launches=pg["launches"][name],
             launches_by_path={"none": launches_none[name], "pose_graph": pg["launches"][name]}, library_ms=None)
        for name, r in kernels.items()
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
