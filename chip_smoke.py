#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases (any failure raises, so the exit code is non-zero):
  1. environment: require CUDA, print the card, build the kernels from csrc/;
  2. data: render the 24-frame 1440x1080 synthetic workload of bench.py;
  2b. the reference's RANSAC draws (phase D, utils/threefry.py, plain
     torch): the workload's pair keys and uniforms, 64 push keys and a
     streamed chunk's 256 pair keys with both LO rounds, made on the card,
     equal bit for bit to the CPU's and, for pairs 0 and 22, to words
     recorded from jax.random; the wall of each draw;
  3. each kernel against its plain PyTorch twin on the card, at the shapes
     the main path gives it (FAST on the four pyramid levels, bit for bit;
     describe at each level's real keypoint origins, words equal and angle
     differences counted; match on the 23 real descriptor pairs plus a
     random K=2048 case), with kernel and plain device times from CUDA
     events (the benchmark's device_ms, benchmark/vobench/kerneltime.py:
     L2 evicted, host overhead hidden; call_ms: one call with its launch),
     the describe row beside the old chain's f32 steering matmul alone, and
     each kernel's bound: kerneltime.bound_ms of the bytes and operations
     that benchmark/roofline/<kernel>.py counts from this run's inputs, at
     the card's published peaks. The match row also carries its bound at
     the popcount rate (for reference), the time of the bf16 matmul of its
     +-1 operands (the distance product alone, no reduction; the port never
     calls it), the time of a launch that does nothing (the floor of that
     timing), and a sweep at P=23 over K = 512, 1024, 2048 plus P=64 at
     K=512, each point exact against the plain twin; the L2 match
     (csrc/l2_match.cu) on the SIFT and SURF sets run_sequence makes of the
     workload at K=8192, cycled to the float_vo cell's 143 pairs (l2_case):
     distances within L2_DIST_TOL of its plain twin run in blocks of pairs,
     indices equal off near-ties, the twin with TF32 on outside those
     tolerances, two launches equal, timed beside its float32 bound;
  4. the port's main path, pipeline.run_experiment(backend="none",
     device="cuda"), with every kernel's launch counter checked (FAST and
     describe once per pyramid level, match once, in the captured VO
     program), the poses, pair status and TUM files checked, the ATE held
     against the JAX reference, and the warm frames/s of run_sequence (a
     replay of its captured graph);
  5. the shipped default, run_experiment(backend="pose_graph") with
     VOConfig(scale_mode="hold") and the default PoseGraphRefineConfig, on
     a 48-frame 1440x1080 loop whose marker shows on its first and last 8
     frames only: launch counters (FAST and describe once per level on the
     frames and again on the keyframe stack, the match at least 3 times),
     the bridge pair and loop edges, the graph cost, poses and TUM files,
     the ATE against the JAX package's; then the kernels at the new shapes
     (FAST and describe on the keyframe stack at k=1024, the match on the
     real retrieval and verification sets at K=1024, each exact against its
     twin and timed beside its bound), the PCG kernel on the first GN
     step's system of the run's padded graph (pcg_case: against its plain
     twin captured as one CUDA graph and against float64, beside its bound,
     with the float64 loop's error when an edge is dropped from its
     product or the gauge is left free, which the held tolerance must
     catch), the PCG's forms (the kernel inside the captured GN step, the
     op-by-op loop with the stop test on the device, and with it read on
     the host each step) timed on the run's graph, the PCG kernel on the
     stream cell's graph (the loop cycled to 513 frames, ten laps, run in
     memory; pcg_case), and the warm wall of pose_graph_trajectory;
  6. backend "ba", run_experiment(backend="ba") with VOConfig(scale_mode=
     "hold") and the default RefineConfig on the same loop: launch counters
     (FAST and describe once per level on the frames and again on the
     keyframe stack, the match at least twice: VO and the tracks, the
     windowed BA kernel once a window run), windows
     run and accepted with their RMS, poses and TUM files, the ATE against
     the JAX package's; the kernels at the path's shapes (the keyframe stack
     at k=512, the match of all its consecutive pairs) and the warm wall of
     refine_trajectory;
  7. streaming, the shipped default at a depth where it switches on by
     itself: the loop at 400 frames of 1440x1080 (2.32 GiB as float32)
     written to a VOSTORE1 file and read back through the native store,
     run_experiment(backend="pose_graph", stream=None, a checkpoint path,
     chunk 256): the switch fired (2 chunks, the second padded), launch
     counters (FAST and describe 4 per chunk and 4 on the keyframe stack),
     the match counts against an in-memory run of the same frames and the
     JAX package's total, a run interrupted in chunk 2 (chunk 1 saved) and
     resumed against the uninterrupted one, the ATE against the JAX package's
     streamed run; per-chunk walls and peak device memory, one chunk's
     store read, host-to-device copy and compute, the warm streamed VO
     frames/s, and the kernels at the chunk shapes against their twins,
     the PCG kernel on the streamed run's own pose graph (pcg_case);
  7a. the JAX package's compiled programs as CUDA graphs (phase G,
     utils/graphs.py): run_sequence on the bench workload (24 frames) and on
     the stream cell's first chunk (257 frames), each replay bit for bit
     against run_sequence_eager; pose_graph.optimize on phase 5's padded
     graph, one GN step a replay, within GRAPH_TOL of optimize_eager, and
     pose_graph_trajectory through the graphs against op by op (loop pairs
     equal, poses within GRAPH_TOL);
     run_ba's captured op-by-op program (run_ba_graph, the whole LM loop)
     on phase 6's windows within GRAPH_TOL of run_ba_eager; run_ba itself
     (one launch of csrc/windowed_ba.cu a float64 window) on each window
     within GRAPH_TOL of run_ba_eager, and at the ba cell's shapes (phase
     6's keyframes at 1000 keypoints: its first window, W = 8, L = 1000,
     and its last) against the eager twin and the captured program it
     replaces (ba_kernel_case); refine_trajectory's accepted windows and
     poses against op by op; loop-closure verification at P = 128, K = 1024 bit
     for bit against its eager twin. Each program captured afresh: capture
     wall, first call, replay wall, eager wall, the replay's device span
     (CUDA events around graph.replay()), graph memory, launches captured.
     Then the JAX package's other jitted calls, which the port runs op by
     op, weighed for capture at the main path's shapes (retrieval's global
     descriptors, similarity and match counts, derive_ground_truth, the
     preprocessor's cast and remap): wall and its spread, kernels and their
     device time, event span. One JSON line {"graphs": ...} with the
     phase's wall;
  7b. ingest and the CLIs (phase I), on the stream phase's 400 frames: 8 of
     them as bags with none, bz2 and lz4 chunks (mono8, rgb8 and bgr8
     images) read to equal arrays, and as PNG CompressedImage messages;
     then all 400 as a ROS1 bag (sensor_msgs/Image mono8, one STag-style
     marker message a frame, lz4 chunks where liblz4 is installed) written
     by tests/torch_bag_data.py; cli.convert --bag (ground truth on the
     card) held against the rendered sequence (frames byte-equal, stamps,
     presence and corners equal, poses within 1e-6, the VOSTORE1 file);
     cli.run_experiment on the .npz with a checkpoint and 384 hypotheses
     (phase 7's config, 2 chunks) held against phase 7's run (match counts
     bit for bit, launches, poses and ATE within 1e-4); cli.analyze on its
     TUM directory and on that of cli.run_experiment --synthetic (the bench
     workload, --profile-dir: the trace written, the summary against an
     in-process run); the kernels at dump_match_images' shapes (a two-frame
     batch, the match at P = 1) against their twins, and dump_match_images
     itself where matplotlib is installed; one JSON line {"ingest": ...}
     with the convert's step walls, the CLI's wall and frames/s;
  8. the float frontends (phase S): on the bench workload, run_sequence with
     VOConfig(frontend=m, match_mode="ratio", dog_threshold=0.5) for m in
     sift and surf: warm wall, frames/s, device idle share, launches (the
     L2 match kernel's alone, once a capture tick); on PARITY.md's clean scenario (60 frames at
     640x480) run_experiment(backend="none"), its ATE and per-pair
     ratio-match counts held to the JAX package's;
  8b. the accuracy-parity harness (phase P,
     droplet_visual_odometry_tpu_torch/parity.py): parity.py's five
     scenarios at full size (clean, corner_noise_1px, marker_gap over three
     render seeds, the 200-frame drift_loop, distorted_1440 with the
     production plumb_bob lens), the reference chain's three variants on
     the host (OpenCV) and every "ours" row through run_experiment on the
     card (none, ba, pose_graph and the default pose_graph+hold; sift and
     surf on clean, phase S's runs, and corner_noise_1px): each port row
     held within twice the JAX package's seed 0-3 spread of its PARITY.md
     row (tools/jax_parity_figures.py), and parity.py's two gates (the best
     port row and the default no worse than the best reference row of this
     run); the distorted_1440 default row's launch counters (8/8/>=3: the
     frames and the keyframe stack); FAST and describe on drift_loop's
     200-frame 640x480 pyramid and the match at P = 199, K = 512 against
     their twins, timed beside their bounds; one JSON line {"parity": ...}
     with every row, hold and margin, the phase's wall and the OpenCV
     version;
  9. OnlineVO (phase O): the bench workload's 24 frames pushed with their
     marker detections, ORB, VOConfig(): every push (one CUDA graph
     replay) equal bit for bit to the same step run op by op, the launches
     in the graph (4/4/1), match counts equal to run_sequence's on the same
     frames and the final pose within ONLINE_POSE_TOL of its chain with the
     same draws; median push ms as a graph and eager, the replay's device
     span (CUDA events around graph.replay()) and the eager step's device
     busy ms under torch.profiler, each push's idle share, the memory the
     graph added; the kernels at the push's shapes (one frame's levels, the
     match at P = 1) against their twins; then a SIFT engine's pushes
     against its eager step. The push draws from the engine's ring of 256
     steps (tools/torch_push_draws.py times the in-graph form beside it);
  10. multi-device (phase M), parallel/ on torch.distributed, one card:
     M1, a world of one rank over NCCL (launch.initialize with a
     coordinator), where the sharded programs are CUDA graphs with their
     NCCL collectives inside: shard_pair_vo on the loop's first 32 pairs
     with VOConfig() and seeded draws (launch counters 8/8/2, one capture
     of 4/4/1 a replay; the rels equal to pair_vo_batched's and to
     run_sequence's on the same 33 frames and draws bit for bit), the
     kernels at its shapes (64 frames, the match at P = 32) against their
     twins, the edge-sharded pose_graph.optimize on phase 5's graph and
     run_ba_distributed on phase 6's windows against their one-device
     forms, each sharded program as a row of phase G's kind against its
     eager twin (bit for bit; optimize within MESH_PCG_TOL), warm walls of
     the captured and eager forms and the NCCL all_reduce latency; its
     teardown drops the mesh's programs before destroying the group;
     M2, two spawned ranks sharing cuda:0 over gloo on CUDA tensors: M1's
     three calls held to like-for-like references made in M1 (see the
     constants), the gloo all_reduce latency, and
     run_experiment(backend="pose_graph") on the loop (pg_mesh_devices 2,
     phase 5's VO chain and loop pairs, poses against phase 5's backend); M3,
     cli.scaling --spawn 2 --ba at 1440x1080 as one JSON line
     {"scaling": ...} (the cost of the process boundary on one card, not
     scaling across cards); then one JSON line {"mesh": ...};
  11. with --profile only: each stage of run_sequence, pose_graph_trajectory
     and refine_trajectory timed alone (host clock, synchronised) and
     torch.profiler over warm runs of the first two (CUDA kernels per run,
     device busy ms, device idle share, the top kernels by device time and,
     for run_sequence, the top aten ops by count), printed as one JSON line
     {"profile": {...}}.
The VO program (run_sequence), the pose-graph GN step, BA and verification
are captured CUDA graphs on the card (phase G), and so are the sharded
programs over an NCCL mesh (M1). A kernel's launch counter
ticks where its wrapper's Python runs: in a program's warm-up and its
capture (CAPTURE_TICKS times a capture), never on a replay. Every counted
run starts with the counters at 0 and no program captured
(reset_launches), so its counts are each captured program's kernels twice
plus the kernels launched op by op (the keyframe stack, retrieval,
tracks).

Then one JSON line with the per-kernel results (`launches` from phase 7's
run, `launches_by_path` from phases 4-10 ("cli": phase I's run of
cli.run_experiment on the converted bag; "mesh": M1's shard_pair_vo;
"parity": phase P's distorted_1440 default row), each run with the counts
set to 0 just before it; "online" per push, counted at the graph's
capture), and last the line {"ok": true, "device": {...}}.

It imports nothing of JAX. Without a GPU, or without the rest of the
repository beside it, it fails before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

# The kernels' timing, peaks and roofline counts are the benchmark's.
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark"))
from roofline import fast_score as fast_roof, hamming_match as match_roof, l2_match as l2_roof  # noqa: E402
from roofline import orb_describe as desc_roof  # noqa: E402
from vobench.kerneltime import F32_OPS_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S, bound_ms, device_ms  # noqa: E402

# NVIDIA's H100 SXM data sheet: float64 outside the tensor cores, at the full 700 W (the windowed BA kernel's rate).
F64_OPS_PER_S = 34e12

# bench.py:43-56 — the reference's benchmark workload.
SEQ_CONFIG = dict(
    n_frames=24, width=1440, height=1080, fx=1170.0, fy=1170.0, n_landmarks=900, landmark_size=0.07
)
SEED = 0

# The JAX package's run_experiment(backend="none") over this sequence, run on
# a CPU: ATE RMSE (m) with RANSAC seeds 0-3 = 0.01515 / 0.02519 / 0.01056 /
# 0.00674, and per-pair crosscheck match counts (the same for every seed: no
# random draw comes before RANSAC). The port draws the JAX package's samples
# for seed 0 (utils/threefry.py), so its ATE is held to seed 0's value at the
# replayed-draw tolerance of ROADMAP C.2, 1 cm (XLA's jit moves the minimal
# 8-point solves, so near-tied MSAC winners reshuffle on a few pairs), and
# its match counts, which no random draw touches, to the reference's within
# 2% in total.
JAX_ATE_RMSE = 0.01515
ATE_TOL = 1e-2
JAX_N_MATCHES = [241, 247, 252, 230, 240, 253, 243, 257, 247, 243, 243, 233, 237, 230, 247, 269, 243, 245, 242, 264, 227, 229, 252]
MATCH_TOL = 0.02
# The JAX package's seed-0 draws, recorded from jax.random on a CPU (jax
# 0.9.0): the first 4 hypothesis uniforms of pairs 0 and 22 of the bench
# workload (uniform(split(PRNGKey(0), 23)[p], (3072,))) and of their LO round
# (uniform(fold_in(key, 1), (1792,))), as float32 bit patterns.
JAX_DRAW_WORDS = {
    0: ((0x3F57A1E6, 0x3E3AC178, 0x3E68A160, 0x3DF73F00), (0x3DD59630, 0x3EB01F24, 0x3E063680, 0x3F4F64B8)),
    22: ((0x3F66A586, 0x3F482248, 0x3DA574D0, 0x3F6202AC), (0x3F3397A8, 0x3EFE1F20, 0x3F6D88A2, 0x3F6B4294)),
}

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

# The BA and stream phases' figures of the JAX package, from
#   JAX_PLATFORMS=cpu python tools/jax_stream_ba_figures.py --seeds 0 1 2 3 --chunk 32
# run on a CPU. BA: run_experiment(backend="ba") with VOConfig(scale_mode="hold")
# and the default RefineConfig on the 48-frame loop gives ATE RMSE (m)
# 0.048091 / 0.052724 / 0.076524 / 0.082439 over RANSAC seeds 0-3 (seed 0:
# 40 keyframes, 7 windows, windows 0, 1, 2, 4 and 5 accepted). Stream: the
# loop at 400 frames, marker on the first and last 8, run_experiment with
# backend="pose_graph" and a checkpoint path (streamed in chunks of 32 pairs:
# the chunk changes only the random keys) gives 0.0029075 / 0.0039869 /
# 0.0031924 / 0.0023856, 43 keyframes, one bridge pair, 9 loop edges and
# 124,496 crosscheck matches over the 399 pairs for every seed. Each ATE is
# held to seed 0's within twice the seed-to-seed spread (max - min).
JAX_BA_ATE_RMSE = 0.048091
BA_ATE_TOL = 0.0687
STREAM_FRAMES = 400
STREAM_CHUNK = 256
STREAM_CELL_FRAMES = 513  # the benchmark's stream cell: the 48-frame loop cycled over ten laps
JAX_STREAM_ATE_RMSE = 0.0029075
STREAM_ATE_TOL = 0.0032
JAX_STREAM_N_MATCHES = 124496

# Phase I: ingest and the CLIs on the stream cell. The small bags' frames and
# encodings; the tolerances: marker poses through the bag's float64
# quaternion and the float32 ground truth, the CLI run against phase 7's
# (its resume tolerance: the pose graph's index_add_ sums in no fixed order
# on the card), analyze's ATE from the TUM files against the run's
# (tum_ate_tolerance: the rotations' drift from orthonormal, which the
# files' quaternions remove, plus TUM_ATE_ULPS float32 ulps of the poses'
# condition number times their distance), and the synthetic CLI run against an
# in-process run of the same rendered frames on the same card.
INGEST_SMALL_FRAMES = 8
INGEST_SMALL_ENCODINGS = ("mono8", "mono8", "rgb8", "mono8", "bgr8", "mono8", "mono8", "rgb8")
POSE_ROUND_TRIP_TOL = 1e-6
RESUME_POSE_TOL = 1e-4
# The PCG kernel's x against the float64 loop on a run's first GN step, as a
# share of max |x|: 100 CG steps that have not converged amplify f32
# rounding (the f32 plain loop lies up to 1.5e-4 from float64 on the test
# chains of tests/test_torch_cuda_kernels.py), and pcg_case checks that an
# edge dropped from the product or a free gauge lands further away.
PCG_TOL = 1e-3
# A captured program's kernels tick their counters twice when it is captured
# (the warm-up run and the capture) and never on a replay (utils/graphs.py).
CAPTURE_TICKS = 2
# Phase G: a replay of optimize or run_ba against its eager twin (C.2's
# index_add_ tolerance: the pose graph's sums run in no fixed order).
GRAPH_TOL = RESUME_POSE_TOL
TUM_ATE_ULPS = 4
SYNTH_ATE_TOL = 1e-6

# Phase S: the float frontends. PARITY.md's `clean` scenario (parity.py:
# scenarios()["clean"]: 60 frames at 640x480) and the JAX package's
# run_experiment(backend="none") with VOConfig(frontend=m, match_mode="ratio",
# dog_threshold=0.5) (parity.py:run_ours, the "ours sift" / "ours surf"
# rows), from
#   JAX_PLATFORMS=cpu python tools/jax_float_frontend_figures.py --seeds 0 1 2 3
# run on a CPU: ATE RMSE (m) over RANSAC seeds 0-3, SIFT 0.209324 / 0.217775 / 0.196381 / 0.192560,
# SURF 0.172966 / 0.172313 / 0.159583 / 0.160401, and the per-pair ratio-match counts
# (the same for every seed). Each ATE is held to seed 0's within twice the
# seed-to-seed spread (max - min); the match counts within 2% in total.
FLOAT_MODES = ("sift", "surf")
CLEAN_SEQ_CONFIG = dict(n_frames=60, width=640, height=480)
JAX_FLOAT_ATE_RMSE = {"sift": 0.209324, "surf": 0.172966}
FLOAT_ATE_TOL = {"sift": 0.050431, "surf": 0.026765}
JAX_FLOAT_N_MATCHES = {
    "sift": [308, 315, 317, 322, 297, 314, 319, 277, 292, 309, 328, 314, 283, 289, 315, 292, 277, 301, 308, 283, 294, 297, 310, 318, 313, 322, 303, 301, 302, 287, 323, 310, 322, 325, 311, 315, 335, 316, 331, 323, 330, 316, 321, 325, 323, 313, 335, 336, 325, 327, 323, 303, 293, 306, 328, 312, 318, 325, 317],
    "surf": [349, 355, 362, 374, 364, 362, 381, 340, 346, 353, 366, 362, 367, 358, 363, 351, 350, 338, 342, 348, 361, 375, 350, 355, 379, 365, 359, 329, 321, 325, 352, 349, 351, 358, 349, 349, 379, 378, 384, 362, 342, 344, 359, 353, 372, 368, 368, 362, 369, 359, 370, 367, 357, 371, 376, 368, 375, 377, 377],
}

# Phase O: OnlineVO on the bench workload. The graph-replayed push must equal
# the same step run op by op bit for bit; the chained pose is held to
# run_sequence's chain over the same frames with the same per-step draws
# (run at P = 23 pairs instead of 1) within ONLINE_POSE_TOL, the C.2 bound on
# chained absolute poses. Pushes timed: ONLINE_TIMED warm pushes each way.
ONLINE_POSE_TOL = 1.2e-2
ONLINE_TIMED = 20

# Phase M: the multi-device layer on the one card. M1 runs a world of one
# rank over NCCL (its collectives really run); M2 two spawned ranks sharing
# cuda:0 over gloo on CUDA tensors (NCCL refuses two ranks on one card); M3
# cli.scaling --spawn 2. Pair VO on the loop's first MESH_PAIRS pairs. M1's
# rels equal pair_vo_batched's and run_sequence's bit for bit; its
# edge-sharded PCG is held within MESH_PCG_TOL (C.2's index_add_ tolerance)
# and its distributed BA within MESH_BA_POSE_TOL / MESH_BA_POINT_TOL (the
# reference's own, tests/test_distributed_ba.py) of their one-device forms.
# M2 is held to M1, and like for like where a 2-rank run changes the
# arithmetic: the card's pair VO depends on the batch size (each rank runs
# B/2 pairs: held bit for bit to pair_vo_batched on those halves; the halves
# differ from one batch by 9.96e-3); a BA window's poses move under a
# reordering of its landmark sums by up to 1.17e-2 on phase 6's windows (each
# held within MESH_BA_POSE_TOL or twice its own reversed-order difference,
# and its cost within MESH_BA_COST_RTOL, the reference's cost tolerance); the
# PCG within MESH_PCG_TOL of the one-device optimize, and M2's run_experiment
# within RESUME_POSE_TOL of phase 5's backend on phase 5's VO chain (the
# figures of chip_smoke.py runs on an NVIDIA H100 80GB HBM3, 700.00 W).
MESH_PAIRS = 32
MESH_PCG_TOL = 1e-4
MESH_BA_POSE_TOL = 2e-3
MESH_BA_POINT_TOL = 2e-2
MESH_BA_COST_RTOL = 0.05
MESH_ALLREDUCE_REPS = 100
MESH_CHILD_TIMEOUT_S = 300
MESH_SCALING_TIMEOUT_S = 600

REPLACES = {
    "fast_score": "droplet_visual_odometry_tpu/ops/pallas_fast.py:193",
    "orb_describe": "droplet_visual_odometry_tpu/ops/pallas_patches.py:103",
    "hamming_match": "droplet_visual_odometry_tpu/ops/pallas_match.py:105",
    "pose_graph_pcg": "none: the CG loop of droplet_visual_odometry_tpu/backend/pose_graph.py:143, XLA ops",
    "l2_match": "none: the float match over l2_matrix, droplet_visual_odometry_tpu/frontend/matcher.py:46, XLA ops",
}

# The L2 match kernel (csrc/l2_match.cu) on the SIFT sets run_sequence makes
# of the bench workload, its 24 frames cycled to the float_vo cell's 144 (143
# pairs of K = 8192), and on the SURF sets (D = 64) alike: d1 and d2 within
# L2_DIST_TOL of the plain twin (unit-norm descriptors, d^2 <= 4, a D-term
# float32 sum in another order), i1 and col_best equal where the line's best
# leads its second by more than L2_GAP (the card tests' tolerances, which
# the twin computed with TF32 fails). The twin runs L2_PLAIN_BLOCK pairs at
# a time: at P = 143 the whole (P, K, K) matrix is 38.4 GB.
L2_PAIRS = 143
L2_K = 8192
L2_DIST_TOL = 2e-6
L2_GAP = 1e-5
L2_PLAIN_BLOCK = 8

# The match's bound at the popcount rate, beside the benchmark's int8 one:
# 32-bit popcounts per clock per SM (16 on sm_90) over the H100 SXM's 132 SMs.
POPC_PER_CLOCK_PER_SM = 16
N_SMS = 132


def log(msg: str) -> None:
    print(msg, flush=True)


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


def roof(n_bytes: float, n_ops: float, ops_per_s: float) -> dict:
    """The benchmark's bound_ms of a call's bytes and operations, with the
    bytes' and the operations' times apart."""
    b_ms, by = bound_ms(n_bytes, n_ops, ops_per_s)
    return dict(bound_ms=b_ms, bound_by=by, bytes_ms=n_bytes / HBM_BYTES_PER_S * 1e3, ops_ms=n_ops / ops_per_s * 1e3)


def sm_clocks_mhz() -> tuple[float, float]:
    """(current, maximum) SM clock of card 0 from nvidia-smi, in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    cur, top = (float(v) for v in out.split(","))
    return cur, top


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


def _bits(t: torch.Tensor) -> np.ndarray:
    """float32 words as their uint32 bit patterns."""
    return t.detach().cpu().contiguous().view(torch.int32).numpy().view(np.uint32)


def phase_draws() -> dict:
    """Phase D, the reference's RANSAC draws on the card (utils/threefry.py:
    plain element-wise torch, no kernel): the bench workload's per-pair keys
    split(PRNGKey(SEED), 23) and their uniforms, a block of 64 push keys
    fold_in(key, step) with theirs, and a streamed chunk's 256 pair keys
    split(fold_in(key, 257), 256) with both LO rounds, each equal bit for
    bit to the same calls on the CPU, and pairs 0 and 22 equal to the words
    recorded from jax.random; then the synchronised host wall of each draw."""
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu_torch.utils import threefry

    rc = VOConfig().ransac
    n_pairs = SEQ_CONFIG["n_frames"] - 1

    def sequence_draws(key):
        return threefry.ransac_uniforms(threefry.split(key, n_pairs), rc)

    def push_draws(key, steps):
        return threefry.ransac_uniforms(threefry.fold_in(key, steps), rc)

    def chunk_draws(key):
        return threefry.ransac_uniforms(threefry.split(threefry.fold_in(key, 257), STREAM_CHUNK),
                                        dataclasses.replace(rc, fused_lo_polish=False))

    def make(device):
        key = threefry.prng_key(SEED, device)
        steps = torch.arange(1, 65, dtype=torch.int64, device=device)
        out = dict(keys=threefry.split(key, n_pairs), push_keys=threefry.fold_in(key, steps))
        out["u_hyp"], out["u_lo"] = sequence_draws(key)
        out["push_hyp"], out["push_lo"] = push_draws(key, steps)
        out["chunk_hyp"], out["chunk_lo"] = chunk_draws(key)
        return out

    gpu, cpu = make("cuda"), make("cpu")
    for name, want in cpu.items():
        got = gpu[name].cpu()
        same = torch.equal(got, want) if want.dtype == torch.int64 else np.array_equal(_bits(got), _bits(want))
        if got.shape != want.shape or not same:
            raise AssertionError(f"the card's threefry {name} differ from the CPU's")
    for p, (hyp, lo) in JAX_DRAW_WORDS.items():
        if _bits(gpu["u_hyp"][p, :4]).tolist() != list(hyp) or _bits(gpu["u_lo"][p, 0, :4]).tolist() != list(lo):
            raise AssertionError(f"pair {p}'s draws differ from the JAX package's recorded words")
    key = threefry.prng_key(SEED, "cuda")
    one = torch.tensor([7], dtype=torch.int64, device="cuda")
    walls = dict(sequence_23_pairs_ms=wall_ms(lambda: sequence_draws(key)),
                 push_one_step_ms=wall_ms(lambda: push_draws(key, one)),
                 push_block_256_ms=wall_ms(lambda: push_draws(key, torch.arange(1, 257, device="cuda"))),
                 chunk_256_pairs_two_rounds_ms=wall_ms(lambda: chunk_draws(key)))
    log(f"draws: the card's threefry keys and uniforms ({', '.join(cpu)}) equal the CPU's bit for bit; pairs "
        f"{sorted(JAX_DRAW_WORDS)} equal the JAX package's recorded words; walls (ms, synchronised host, median of 7) "
        f"{walls}")
    return dict(equal_cpu=sorted(cpu), equal_jax_pairs=sorted(JAX_DRAW_WORDS), wall_ms=walls)


def fast_plain(level: torch.Tensor) -> torch.Tensor:
    """FAST's plain twin over PLAIN_FRAMES frames at a time (it holds 16
    shifted copies of its input: a 257-frame chunk at once would not fit)."""
    from droplet_visual_odometry_tpu_torch.ops import cuda_fast

    return torch.cat([cuda_fast.fast_score_plain(level[i : i + PLAIN_FRAMES], 20.0, 9)
                      for i in range(0, level.shape[0], PLAIN_FRAMES)])


PLAIN_FRAMES = 48


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
        out_p = fast_plain(level)
        torch.cuda.synchronize()
        if not torch.equal(out_k, out_p):  # the same f32 ops in the same neighbour order
            raise AssertionError(f"FAST {label} level {l}: {int((out_k != out_p).sum())} px differ from plain, "
                                 f"max {float((out_k - out_p).abs().max())}")
        r = roof(*fast_roof.counts(level), F32_OPS_PER_S)
        ms = device_ms(lambda: cuda_fast.fast_score_cuda(level, 20.0, 9))
        fast_r["ms"] += ms
        fast_r["call_ms"] += call_ms(lambda: cuda_fast.fast_score_cuda(level, 20.0, 9))
        fast_r["plain_ms"] += device_ms(lambda: fast_plain(level), reps=3, warmup=1)
        for f in ("bound_ms", "bytes_ms", "ops_ms"):
            fast_r[f] += r[f]
        log(f"fast_score {label} level {l} {tuple(level.shape)}: equal to plain; corners {int((out_k > 0).sum())}; "
            f"kernel {ms:.4f} ms, bound {r['bound_ms']:.4f} ms")

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
        r = roof(*desc_roof.counts(blur, origins), F32_OPS_PER_S)
        q = torch.round(cuda_describe.extract_patches_plain(blur, origins).reshape(m, -1))
        steer = cuda_describe._steer_w(q.device)
        ms = device_ms(lambda: cuda_describe.describe_cuda(blur, origins))
        desc_r["ms"] += ms
        desc_r["call_ms"] += call_ms(lambda: cuda_describe.describe_cuda(blur, origins))
        desc_r["plain_ms"] += device_ms(lambda: cuda_describe.describe_plain(blur, origins))
        desc_r["steer_matmul_ms"] += device_ms(lambda: q @ steer)
        for f in ("bound_ms", "bytes_ms", "ops_ms"):
            desc_r[f] += r[f]
        desc_r["patch_mb"] += m * cuda_describe.PATCH**2 * 4 / 1e6
        log(f"orb_describe {label} level {l}: {m} keypoints, words equal to plain, {differ} angles differ "
            f"(max {float((ak - ap).abs().max())}), no bin differs; kernel {ms:.4f} ms, bound {r['bound_ms']:.4f} ms")
    return fast_r, desc_r


def match_case(label: str, da, db, va, vb) -> dict:
    """The match kernel on one set of pairs: exact against its plain twin,
    timed beside its int8-rate bound."""
    from droplet_visual_odometry_tpu_torch.ops import cuda_match

    args = [t.contiguous() for t in (da, db, va, vb)]
    err = check_match(label, *args)
    p, k = args[0].shape[0], args[0].shape[1]
    ms = device_ms(lambda: cuda_match.match_reductions_cuda(*args))
    plain_ms = device_ms(lambda: cuda_match.match_reductions_plain(*args), reps=3, warmup=1)
    b_ms = roof(*match_roof.counts(p, k), INT8_OPS_PER_S)["bound_ms"]
    log(f"match {label} P={p} K={k}: kernel {ms:.4f} ms, int8 bound {b_ms:.4f} ms ({b_ms / ms:.3f}), "
        f"plain {plain_ms:.4f} ms")
    return dict(p=p, k=k, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, share=b_ms / ms, max_abs_err=err)


def l2_pairs(seq, mode: str) -> tuple[torch.Tensor, ...]:
    """The float frontend's sets of the bench workload, as run_sequence makes
    them (the remapped frames, K = L2_K), at the float_vo cell's L2_PAIRS
    pairs: the frames cycled as the benchmark cycles a clip (frame i is
    frame i mod (n - 1)). (desc_a, desc_b, valid_a, valid_b), contiguous."""
    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.frontend import sift, surf

    frames = pipeline.make_preprocessor(seq, "cuda")(seq.frames)
    feats = {"sift": sift, "surf": surf}[mode].detect_and_describe(frames, k=L2_K)
    idx = torch.arange(L2_PAIRS + 1, device="cuda") % (len(seq) - 1)
    return tuple(t[i].contiguous() for t in (feats.desc, feats.valid) for i in (idx[:-1], idx[1:]))


def l2_plain_blocks(a, b, va, vb):
    """The L2 match's plain twin L2_PLAIN_BLOCK pairs at a time."""
    from droplet_visual_odometry_tpu_torch.ops import cuda_l2match

    parts = [cuda_l2match.l2_match_reductions_plain(a[s:s + L2_PLAIN_BLOCK], b[s:s + L2_PLAIN_BLOCK],
                                                    va[s:s + L2_PLAIN_BLOCK], vb[s:s + L2_PLAIN_BLOCK])
             for s in range(0, a.shape[0], L2_PLAIN_BLOCK)]
    return tuple(torch.cat(x) for x in zip(*parts))


def l2_col_gaps(a, b, va, vb) -> torch.Tensor:
    """(P, K): each column's second-least squared distance less its least."""
    from droplet_visual_odometry_tpu_torch.ops import cuda_l2match

    gaps = []
    for s in range(0, a.shape[0], L2_PLAIN_BLOCK):
        sl = slice(s, s + L2_PLAIN_BLOCK)
        two = torch.topk(cuda_l2match.l2_matrix(a[sl], b[sl], va[sl], vb[sl]), 2, dim=-2, largest=False).values
        gaps.append(two[:, 1] - two[:, 0])
    return torch.cat(gaps)


def l2_differ(got, want, row_gap, col_gap) -> dict:
    """How far the kernel's (d1, i1, d2, col_best) lie from the twin's: the
    largest distance error, and the indices that differ off near-ties."""
    rows, cols = row_gap > L2_GAP, col_gap > L2_GAP
    return dict(max_abs_err=max(float((got[0] - want[0]).abs().max()), float((got[2] - want[2]).abs().max())),
                i1_differ=int((got[1] != want[1])[rows].sum()), col_best_differ=int((got[3] != want[3])[cols].sum()),
                rows_compared=int(rows.sum()), cols_compared=int(cols.sum()))


def l2_case(seq, mode: str) -> dict:
    """The L2 match kernel on the float frontend's sets at the float_vo
    cell's shapes: within the tolerances of its plain twin (TF32 off), the
    same twin with TF32 on outside them, timed beside its float32 bound."""
    from droplet_visual_odometry_tpu_torch.ops import cuda_l2match

    torch.backends.cuda.matmul.allow_tf32 = False
    args = l2_pairs(seq, mode)
    p, k, d = args[0].shape
    got = cuda_l2match.l2_match_reductions_cuda(*args)
    want = l2_plain_blocks(*args)
    row_gap, col_gap = want[2] - want[0], l2_col_gaps(*args)
    r = l2_differ(got, want, row_gap, col_gap)
    if r["max_abs_err"] > L2_DIST_TOL or r["i1_differ"] or r["col_best_differ"]:
        raise AssertionError(f"l2_match {mode} {(p, k, d)} against its twin: {r}")
    if r["rows_compared"] < 0.5 * p * k or r["cols_compared"] < 0.5 * p * k:
        raise AssertionError(f"l2_match {mode}: too few lines clear of near-ties to compare: {r}")
    # The tolerances' teeth on these sets: the first block's twin with TF32 matmuls.
    sl = slice(0, L2_PLAIN_BLOCK)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = l2_plain_blocks(*(t[sl] for t in args))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    t = l2_differ(tuple(x[sl] for x in got), tf32, row_gap[sl], col_gap[sl])
    if t["max_abs_err"] <= L2_DIST_TOL and not (t["i1_differ"] or t["col_best_differ"]):
        raise AssertionError(f"l2_match {mode}: the TF32 twin passes the tolerances: {t}")
    again = cuda_l2match.l2_match_reductions_cuda(*args)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"l2_match {mode}: two launches differ")
    ms = device_ms(lambda: cuda_l2match.l2_match_reductions_cuda(*args))
    row = dict(p=p, k=k, d=d, ms=ms, call_ms=call_ms(lambda: cuda_l2match.l2_match_reductions_cuda(*args), reps=5),
               plain_ms=device_ms(lambda: l2_plain_blocks(*args), reps=3, warmup=1),
               **roof(*l2_roof.counts(p, k, d), F32_OPS_PER_S), **r, tf32_twin=t,
               valid_share=float(args[2].float().mean()))
    row["share"] = row["bound_ms"] / ms
    log(f"l2_match {mode} P={p} K={k} D={d} (valid {row['valid_share']:.4f}): within {L2_DIST_TOL} of plain "
        f"(max {r['max_abs_err']:.3g}; indices equal on {r['rows_compared']} rows, {r['cols_compared']} columns "
        f"clear of near-ties), TF32 twin {t['max_abs_err']:.3g} with {t['i1_differ']} / {t['col_best_differ']} "
        f"indices off; two launches equal; kernel {ms:.4f} ms, one call {row['call_ms']:.4f} ms, f32 bound "
        f"{row['bound_ms']:.4f} ms ({row['share']:.3f}), plain in blocks of {L2_PLAIN_BLOCK} {row['plain_ms']:.4f} ms")
    return row


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
    match_r = roof(*match_roof.counts(p, km), INT8_OPS_PER_S)
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
        s_bound = roof(*match_roof.counts(sp, sk), INT8_OPS_PER_S)["bound_ms"]
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
            **match_r, popc_bound_ms=popc_ms,
            matmul_ms=matmul_ms, empty_launch_ms=floor_ms, k_sweep=sweep,
            sm_clock_mhz=clock_now, sm_clock_max_mhz=clock_max,
            source="droplet_visual_odometry_tpu_torch/csrc/hamming_match.cu",
        ),
    }
    # Kernel 6: the float match at the float_vo cell's shapes, SIFT (the row) and SURF.
    l2 = l2_case(seq, "sift")
    results["l2_match"] = dict(l2, surf=l2_case(seq, "surf"), source="droplet_visual_odometry_tpu_torch/csrc/l2_match.cu")
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

    reset_launches()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        res = pipeline.run_experiment(seq, VOConfig(), out_dir, SEED, backend="none", device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = read_launches()
        log(f"run_experiment (cold, incl. upload) {cold_s:.2f} s; kernel launches {launches}")
        # run_sequence is one captured program: its kernels tick at its capture only.
        want = CAPTURE_TICKS * VOConfig().n_levels
        if launches["fast_score"] != want or launches["orb_describe"] != want:
            raise AssertionError(f"expected {want} FAST and describe launches (one per level, captured), "
                                 f"got {launches}")
        if launches["hamming_match"] != CAPTURE_TICKS:
            raise AssertionError(f"expected {CAPTURE_TICKS} match launches (captured once), got {launches}")
        n = len(seq)
        traj = res.trajectory
        check_run_outputs(res, out_dir, n)
        ok_frac = float(np.mean(traj.ok))
        if ok_frac < 0.9:
            raise AssertionError(f"only {ok_frac:.2f} of pairs ok")
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
    return launches, traj


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
    read on the host every step: the other form of ops/cuda_pcg.pcg,
    which issues all iters steps and sets the step length to 0 on the
    device once the test fails. Counts its steps in PCG_STEPS and returns
    them beside x, as `pcg` returns its live steps."""
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
    return x, torch.tensor(k, dtype=torch.int32, device=b.device)


PCG_STEPS: list[int] = []


@contextlib.contextmanager
def recording_optimize():
    """Within: pose_graph.optimize appends each graph it is given (as the
    caller padded it) to the list this yields."""
    from droplet_visual_odometry_tpu_torch.backend import pose_graph

    seen, optimize = [], pose_graph.optimize

    def recording(graph, *args, **kwargs):
        seen.append(graph)
        return optimize(graph, *args, **kwargs)

    pose_graph.optimize = recording
    try:
        yield seen
    finally:
        pose_graph.optimize = optimize


def cycled(seq, n: int):
    """A closed loop's sequence cycled over its frames 0 .. len - 2 to n
    frames, as the benchmark cycles its clip for the stream cell (the last
    frame sits at the first one's pose, so no step teleports)."""
    idx = np.arange(n) % (len(seq) - 1)
    dt = float(seq.timestamps[1] - seq.timestamps[0])
    per_frame = {f: getattr(seq, f)[idx] for f in ("frames", "marker_corners", "marker_poses", "marker_present",
                                                   "marker_ids", "gt_poses") if getattr(seq, f) is not None}
    return dataclasses.replace(seq, timestamps=seq.timestamps[0] + dt * np.arange(n), **per_frame)


def pcg_case(label: str, graph, pg_cfg) -> dict:
    """The PCG kernel on the first GN step's system (B, b, M^-1, as
    pose_graph._solve_pcg builds them) of a run's padded graph: its device
    time (device_ms) and one call with its launch (call_ms) against its
    plain twin, pcg_plain's op-by-op loop captured as one CUDA graph
    (utils/graphs.py), beside its bound (the inputs read once and x written
    at 3.35 TB/s, or 90 FLOPs an edge and 160 a node per live iteration at
    the f32 rate). Holds x within PCG_TOL of max |x| of the float64 loop,
    the kernel's and the f32 plain loop's live counts equal to float64's,
    and shows the tolerance has teeth: the float64 loop with its strongest
    real edge dropped from the product, or with the gauge left free in the
    product, lands further than PCG_TOL from it."""
    from droplet_visual_odometry_tpu_torch.backend import pose_graph
    from droplet_visual_odometry_tpu_torch.ops import cuda_pcg
    from droplet_visual_odometry_tpu_torch.utils import graphs

    M, E = int(graph.poses.shape[0]), int(graph.edge_i.shape[0])
    ei, ej = graph.edge_i.contiguous(), graph.edge_j.contiguous()
    B, g = pose_graph._edge_blocks(graph.poses, graph)
    b, Minv = pose_graph._pcg_system(M, graph, B, g, pg_cfg.damping)
    B = B.contiguous()
    args = (pg_cfg.damping, pg_cfg.cg_iters, pg_cfg.cg_tol)
    system = (B, ei, ej, b, Minv)
    x, live = cuda_pcg.pcg_cuda(*system, *args)
    x_plain, live_plain = cuda_pcg.pcg_plain(*system, *args)
    B64, b64, Minv64 = B.double(), b.double(), Minv.double()
    x64, live64 = cuda_pcg.pcg_plain(B64, ei, ej, b64, Minv64, *args)
    scale = float(x64.abs().max())
    rel = lambda u: float((u.double() - x64).abs().max()) / scale
    real = ei != ej
    strongest = int(torch.argmax(B64.abs().flatten(1).sum(1) * real))
    B_drop = B64.clone()
    B_drop[strongest] = 0.0
    x_drop, _ = cuda_pcg.pcg(cuda_pcg.matvec_local(B_drop, ei, ej, pg_cfg.damping, M), b64, Minv64,
                             pg_cfg.cg_iters, pg_cfg.cg_tol)
    x_free, _ = cuda_pcg.pcg(lambda v: cuda_pcg.hx_local(B64, ei, ej, v) + pg_cfg.damping * v, b64, Minv64,
                             pg_cfg.cg_iters, pg_cfg.cg_tol)
    case = dict(nodes=int(torch.unique(torch.cat([ei[real], ej[real]])).numel()), edges=int(real.sum()),
                bucket=[M, E], blocks=list(cuda_pcg.plan(M, E)),
                live=int(live), live_plain=int(live_plain), live_f64=int(live64),
                err_f64=rel(x), err_plain_f64=rel(x_plain), err_kernel_plain=float((x - x_plain).abs().max()) / float(x_plain.abs().max()),
                err_dropped_edge=rel(x_drop), err_free_gauge=rel(x_free))
    repeat = cuda_pcg.pcg_cuda(*system, *args)
    case["repeats_bit_for_bit"] = bool(torch.equal(repeat[0], x) and torch.equal(repeat[1], live))
    plain_body = lambda *t: cuda_pcg.pcg_plain(*t, *args)
    case["ms"] = device_ms(lambda: cuda_pcg.pcg_cuda(*system, *args))
    case["call_ms"] = call_ms(lambda: cuda_pcg.pcg_cuda(*system, *args))
    case["plain_ms"] = device_ms(lambda: graphs.run("pcg_plain_alone", plain_body, system, args, B.device), reps=5)
    case["us_per_iter"] = case["ms"] * 1e3 / max(int(live), 1)
    bytes_moved = sum(t.numel() * t.element_size() for t in system) + x.numel() * 4 + 4
    case.update(roof(bytes_moved, int(live) * (90 * E + 160 * M), F32_OPS_PER_S))
    case["share"] = case["bound_ms"] / case["ms"]
    log(f"pcg {label}: {case['nodes']} nodes, {case['edges']} real edges in the bucket {M}x{E} on "
        f"{case['blocks'][0]} block(s) of {case['blocks'][1]} warps; kernel {case['ms']:.4f} ms "
        f"({case['us_per_iter']:.2f} us an iteration, one call {case['call_ms']:.4f} ms), plain loop captured "
        f"{case['plain_ms']:.4f} ms, bound {case['bound_ms']:.6f} ms ({case['bound_by']}); live {case['live']}/{case['live_plain']}/"
        f"{case['live_f64']}; x vs float64 {case['err_f64']:.2e} (f32 plain loop {case['err_plain_f64']:.2e}, "
        f"kernel vs plain {case['err_kernel_plain']:.2e}); float64 with the strongest edge dropped "
        f"{case['err_dropped_edge']:.2e}, with the gauge free {case['err_free_gauge']:.2e}; tolerance {PCG_TOL}")
    if not case["repeats_bit_for_bit"] or not case["live"] == case["live_plain"] == case["live_f64"]:
        raise AssertionError(f"pcg {label}: the kernel's repeat or live counts disagree")
    if case["err_f64"] > PCG_TOL or min(case["err_dropped_edge"], case["err_free_gauge"]) <= PCG_TOL:
        raise AssertionError(f"pcg {label}: the kernel lies {case['err_f64']:.2e} from float64, or a mutated "
                             f"product lies within {PCG_TOL} of it")
    return case


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
    from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch
    from droplet_visual_odometry_tpu_torch.ops import cuda_pcg

    vo, cfg = VOConfig(scale_mode="hold"), refine.PoseGraphRefineConfig()
    reset_launches()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        res = pipeline.run_experiment(seq, vo, out_dir, SEED, backend="pose_graph", device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = read_launches()
        info = res.backend_info
        log(f"run_experiment(backend='pose_graph') (cold, incl. upload) {cold_s:.2f} s; kernel launches {launches}")
        log(f"backend info {json.dumps(info)}")
        want = (CAPTURE_TICKS + 1) * vo.n_levels
        if launches["fast_score"] != want or launches["orb_describe"] != want:
            raise AssertionError(f"expected {want} FAST and describe launches (one per level: the captured VO "
                                 f"program, then the keyframe stack op by op), got {launches}")
        if launches["hamming_match"] < 2 * CAPTURE_TICKS + 1:
            raise AssertionError(f"expected >= {2 * CAPTURE_TICKS + 1} match launches (captured VO, retrieval, "
                                 f"captured verification), got {launches}")
        if launches["pose_graph_pcg"] != CAPTURE_TICKS:
            raise AssertionError(f"expected {CAPTURE_TICKS} PCG launches (the GN step's program, captured once, "
                                 f"runs its CG in one kernel launch), got {launches}")
        check_run_outputs(res, out_dir, len(seq))
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

    # The run's pose graph: the PCG kernel alone on its first GN step, then the PCG's forms through optimize.
    edges = loop_closure.find_loop_closures(
        feats, d["vo_abs"][d["kf_idx"]], d["corners"][d["kf_idx"]], seq.marker_present[d["kf_idx"]], d["K"], d["L"],
        vo, lc, extra_pairs=d["extra"])
    graph = refine.loop_graph(d["vo_abs"][d["kf_idx"]], d["kf_idx"], edges, d["traj"].n_inliers, cfg,
                              d["traj"].scale_ok, "cuda")
    m = int(graph.poses.shape[0])
    graph = pose_graph.pad_graph(graph, pose_graph.next_bucket(m), pose_graph.next_bucket(int(graph.edge_i.shape[0])))
    results["pose_graph_pcg"] = dict(pcg_case("loop run", graph, cfg.pg),
                                     source="droplet_visual_odometry_tpu_torch/csrc/pose_graph_pcg.cu")
    # The PCG's forms: the kernel inside the captured GN step (optimize), the op-by-op loop with its stop
    # on the device (optimize_eager, the kernel path off), and the host-read stop, which only runs op by op.
    in_kernel, device_pcg = pose_graph._pcg_in_kernel, cuda_pcg.pcg
    op_by_op = lambda *a, **k: False
    forms = {"graph": (pose_graph.optimize, in_kernel, device_pcg),
             "device": (pose_graph.optimize_eager, op_by_op, device_pcg),
             "host": (pose_graph.optimize_eager, op_by_op, pcg_host_stop)}

    def run_form(name, fn):
        opt, pose_graph._pcg_in_kernel, cuda_pcg.pcg = forms[name]
        try:
            return fn(opt)
        finally:
            pose_graph._pcg_in_kernel, cuda_pcg.pcg = in_kernel, device_pcg

    graph_stop = run_form("graph", lambda opt: opt(graph, cfg.pg))
    device_stop = run_form("device", lambda opt: opt(graph, cfg.pg))
    PCG_STEPS.clear()
    host_stop = run_form("host", lambda opt: opt(graph, cfg.pg))
    steps = list(PCG_STEPS)
    # In turns (graph, device, host, host, device, graph), each turn the median of 3 calls.
    turns = {"graph": [], "device": [], "host": []}
    for name in ("graph", "device", "host", "host", "device", "graph"):
        turns[name].append(run_form(name, lambda opt: wall_ms(lambda: opt(graph, cfg.pg), reps=3)))
    graph_ms_, device_ms_, host_ms = (float(np.mean(turns[k])) for k in ("graph", "device", "host"))
    cost_dev, cost_host = float(device_stop.final_cost), float(host_stop.final_cost)
    pose_dev = max(float((device_stop.poses - host_stop.poses).abs().max()),
                   float((graph_stop.poses - host_stop.poses).abs().max()))
    log(f"PCG optimize on a graph of {m} nodes, {len(edges.i)} loop edges (padded to {tuple(graph.poses.shape)[0]} "
        f"nodes, {graph.edge_i.shape[0]} edges), {cfg.pg.iters} GN steps: the CG kernel in the captured GN step "
        f"{graph_ms_:.2f} ms (turns {turns['graph']}), op by op with the stop on the device ({cfg.pg.cg_iters} CG "
        f"steps issued) {device_ms_:.2f} ms (turns {turns['device']}), host-read stop op by op {host_ms:.2f} ms (turns "
        f"{turns['host']}; CG steps per GN step {steps}); "
        f"final cost {cost_dev!r} vs {cost_host!r}, poses differ by {pose_dev:.2e}")
    if abs(cost_dev - cost_host) > 1e-3 * abs(cost_host) or pose_dev > 1e-4:
        raise AssertionError("the PCG forms disagree")

    # The stream cell's pose graph: this loop cycled to STREAM_CELL_FRAMES frames (ten laps), run in memory.
    with recording_optimize() as seen:
        laps = pipeline.run_experiment(cycled(seq, STREAM_CELL_FRAMES), vo, None, SEED, backend="pose_graph",
                                       stream=False, device="cuda")
    log(f"{STREAM_CELL_FRAMES} frames, the loop cycled: backend info {json.dumps(laps.backend_info)}")
    results["pose_graph_pcg"]["ten_laps"] = pcg_case("ten laps", seen[0], cfg.pg)
    del laps

    args = (d["frames"], d["vo_abs"], d["traj"].n_inliers, d["corners"], seq.marker_present, d["K"], d["L"], vo, cfg)
    kw = dict(pair_scale_ok=d["traj"].scale_ok)
    warm_ms = wall_ms(lambda: refine.pose_graph_trajectory(*args, **kw), reps=3)
    log(f"pose_graph_trajectory warm: {warm_ms:.2f} ms over {d['n_kf']} keyframes of {len(seq)} frames")
    return dict(launches=launches, ate_rmse=res.ate.rmse, info=info, cold_s=cold_s, warm_ms=warm_ms,
                pcg=dict(graph_ms=graph_ms_, device_stop_ms=device_ms_, host_stop_ms=host_ms, turns_ms=turns,
                         cg_steps=steps, nodes=m, padded_nodes=int(graph.poses.shape[0]),
                         padded_edges=int(graph.edge_i.shape[0])),
                inputs=d, feats=feats, graph=graph, edges=edges)


def profile_pose_graph(seq, pg: dict) -> dict:
    """Each stage of backend/refine.pose_graph_trajectory timed alone on the
    loop run's inputs (host clock, synchronised, median of 7), and
    torch.profiler over two warm calls."""
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
    # find_loop_closures' draws: the reference's threefry uniforms, made once and cached.
    draws = loop_closure.reference_draws(R * n_slot, vcfg.ransac, 0, Kt.device)
    verify = lambda: loop_closure._verify_candidates(feats, corners, mvalid, Kt, d["L"], vcfg, ca_p, cb_p, *draws)
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
        "verification_draws_uncached": lambda: loop_closure.reference_draws.__wrapped__(R * n_slot, vcfg.ransac, 0,
                                                                                        Kt.device),
        "host_selection": lambda: (loop_closure._select_candidates(ia, ib, counts, lc),
                                   loop_closure._pick_restarts(res, R, n_slot)),
        "pcg_optimize": lambda: pose_graph.optimize(pg["graph"], cfg.pg),
        "reanchor": lambda: refine.reanchor_segments(d["vo_abs"], kf, refined_kf),
    }
    out = {"stage_ms": {name: wall_ms(fn) for name, fn in stages.items()}}
    args = (d["frames"], d["vo_abs"], d["traj"].n_inliers, d["corners"], seq.marker_present, d["K"], d["L"], vo, cfg)
    call = lambda: refine.pose_graph_trajectory(*args, pair_scale_ok=d["traj"].scale_ok)
    out["pose_graph_trajectory_ms"] = wall_ms(call, reps=3)
    out.update(device_profile(call, runs=2, top=10)[0])
    return out


def check_run_outputs(res, out_dir: str, n: int) -> None:
    """Raise unless the run's poses are finite and shaped and its six TUM files parse."""
    from droplet_visual_odometry_tpu_torch.eval import tum

    if not (np.isfinite(res.vo_abs).all() and res.vo_abs.shape == (n, 4, 4)):
        raise AssertionError("non-finite or misshapen absolute poses")
    for name in tum.STREAM_NAMES:
        stamps, poses = tum.read_tum(os.path.join(out_dir, name))
        rows = n if name.endswith("absolute.txt") else n - 1
        if stamps.shape != (rows,) or not np.isfinite(poses).all():
            raise AssertionError(f"{name}: {stamps.shape} rows, finite={np.isfinite(poses).all()}")


def reset_launches() -> None:
    """Set the kernels' launch counters to 0 and drop every captured program
    (utils/graphs.py), so the run that follows captures each program it
    runs, and its counts show each program's kernels: the counters tick
    where a wrapper's Python runs (a capture's warm-up and the capture
    itself, CAPTURE_TICKS per kernel of the program), never on a replay."""
    from droplet_visual_odometry_tpu_torch.ops import (
        cuda_ba, cuda_describe, cuda_fast, cuda_l2match, cuda_match, cuda_pcg)
    from droplet_visual_odometry_tpu_torch.utils import graphs

    for mod in (cuda_fast, cuda_describe, cuda_match, cuda_pcg, cuda_ba, cuda_l2match):
        mod.LAUNCHES = 0
    graphs.clear()


def read_launches() -> dict:
    from droplet_visual_odometry_tpu_torch.utils import graphs

    return graphs.launch_counts()


def frontend_row(r: dict) -> dict:
    return {k: r[k] for k in ("ms", "plain_ms", "bound_ms")}


def accepted_windows(info: dict) -> list[int]:
    return [i for i, r in enumerate(info.get("window_corr", [])) if r["accepted"]]


def phase_ba(seq, results) -> dict:
    """backend="ba": run_experiment with VOConfig(scale_mode="hold") and the
    default RefineConfig on the loop sequence: launch counters (FAST and
    describe once per level on the frames and again on the keyframe stack,
    the match at least once more for the tracks), windows run and accepted,
    poses and TUM files, the ATE against the JAX package's; then the
    kernels at the path's shapes (the keyframe stack at k=512, the match of
    all its consecutive pairs) and the warm wall of refine_trajectory."""
    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.backend import keyframes, refine, tracks
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch

    vo, cfg = VOConfig(scale_mode="hold"), refine.RefineConfig()
    reset_launches()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        res = pipeline.run_experiment(seq, vo, out_dir, SEED, backend="ba", device="cuda")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = read_launches()
        check_run_outputs(res, out_dir, len(seq))
    info = res.backend_info
    accepted = accepted_windows(info)
    log(f"run_experiment(backend='ba') (cold, incl. upload) {cold_s:.2f} s; kernel launches {launches}")
    log(f"backend info {json.dumps(info)}")
    want = (CAPTURE_TICKS + 1) * vo.n_levels
    if launches["fast_score"] != want or launches["orb_describe"] != want:
        raise AssertionError(f"expected {want} FAST and describe launches (one per level: the captured VO "
                             f"program, then the keyframe stack op by op), got {launches}")
    if launches["hamming_match"] < CAPTURE_TICKS + 1:
        raise AssertionError(f"expected >= {CAPTURE_TICKS + 1} match launches (captured VO, tracks), got {launches}")
    if launches["windowed_ba"] != info["windows"]:
        raise AssertionError(f"expected one windowed BA launch a window run ({info['windows']}), got {launches}")
    if info["windows"] < 1 or not accepted:
        raise AssertionError(f"{info['windows']} BA windows run, {len(accepted)} accepted")
    log(f"BA: {info['n_keyframes']} keyframes, {info['windows']} windows run, accepted {accepted}, "
        f"rms_px {info['rms_px']}")
    log(f"ba ATE rmse {res.ate.rmse!r} m (JAX package {JAX_BA_ATE_RMSE} +- {BA_ATE_TOL}); "
        f"RPE {res.rpe.trans_rmse!r} m / {res.rpe.rot_rmse_deg!r} deg")
    if abs(res.ate.rmse - JAX_BA_ATE_RMSE) > BA_ATE_TOL:
        raise AssertionError(f"ba ATE {res.ate.rmse} outside {JAX_BA_ATE_RMSE} +- {BA_ATE_TOL}")

    frames = pipeline.make_preprocessor(seq, "cuda")(seq.frames)
    K = pipeline.effective_K(seq).astype(np.float32)
    corners = pipeline.effective_marker_corners(seq, K)
    vo_abs, n_inliers = np.asarray(res.trajectory.abs_poses, np.float64), res.trajectory.n_inliers
    kf_idx = np.where(keyframes.select_keyframes(vo_abs, n_inliers, cfg.kf))[0]
    if len(kf_idx) != info["n_keyframes"]:
        raise AssertionError(f"{len(kf_idx)} keyframes rebuilt, the run had {info['n_keyframes']}")
    kf_frames = frames[torch.as_tensor(kf_idx, device="cuda")]
    fast_kf, desc_kf = frontend_levels(kf_frames, cfg.n_keypoints, "BA keyframe stack")
    feats = detect_and_describe_batch(kf_frames, k=cfg.n_keypoints, threshold=cfg.fast_threshold)
    tracks_case = match_case("BA tracks", feats.desc[:-1], feats.desc[1:], feats.valid[:-1], feats.valid[1:])
    results["fast_score"]["ba_keyframe_stack"] = frontend_row(fast_kf)
    results["orb_describe"]["ba_keyframe_stack"] = frontend_row(desc_kf)
    results["hamming_match"]["ba_tracks"] = tracks_case
    args = (frames, vo_abs, n_inliers, K, cfg)
    kw = dict(marker_corners=corners, real_marker_length=seq.real_marker_length)
    warm_ms = wall_ms(lambda: refine.refine_trajectory(*args, **kw), reps=3)
    log(f"refine_trajectory warm: {warm_ms:.2f} ms over {len(kf_idx)} keyframes, {info['windows']} windows")
    return dict(launches=launches, ate_rmse=res.ate.rmse, info=info, cold_s=cold_s, warm_ms=warm_ms,
                inputs=dict(frames=frames, kf_frames=kf_frames, kf_idx=kf_idx, feats=feats, args=args, kw=kw,
                            matches=tracks.match_consecutive(feats)))


def profile_ba(ba: dict) -> dict:
    """Each stage of backend/refine.refine_trajectory timed alone on the BA
    run's inputs (host clock, synchronised, median of 3), summed over its
    windows as refine_trajectory walks them, and torch.profiler over run_ba
    on the last window."""
    from droplet_visual_odometry_tpu_torch.backend import ba as ba_mod
    from droplet_visual_odometry_tpu_torch.backend import refine, tracks
    from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch
    from droplet_visual_odometry_tpu_torch.frontend.matcher import Matches
    from droplet_visual_odometry_tpu_torch.frontend.orb import Features

    d = ba["inputs"]
    frames, vo_abs, n_inliers, K, cfg = d["args"]
    feats, matches, kf_idx = d["feats"], d["matches"], d["kf_idx"]
    Kt = torch.as_tensor(K, device="cuda")
    stage = {"keyframe_frontend": wall_ms(lambda: detect_and_describe_batch(d["kf_frames"], k=cfg.n_keypoints,
                                                                          threshold=cfg.fast_threshold), reps=3),
             "tracks_match": wall_ms(lambda: tracks.match_consecutive(feats), reps=3),
             "tracks_chain": 0.0, "triangulate_filter": 0.0, "run_ba": 0.0, "gates": 0.0}
    run_ba_ms = []
    refined = vo_abs[kf_idx].copy()
    W = min(cfg.window, len(kf_idx))
    start = 0
    while start < len(kf_idx) - 2:
        end = min(start + W, len(kf_idx))
        sl = slice(start, end)
        poses0 = torch.as_tensor(refined[sl], dtype=torch.float32, device="cuda")
        wf, wm = Features(*(a[sl] for a in feats)), Matches(*(a[start : end - 1] for a in matches))
        grid = tracks.build_tracks(wf, wm)
        stage["tracks_chain"] += wall_ms(lambda: tracks.build_tracks(wf, wm), reps=3)

        def tri():
            X, valid = tracks.triangulate_tracks(grid, poses0, Kt, min_views=cfg.min_views)
            return X, valid, tracks.filter_by_reprojection(grid, X, poses0, Kt, cfg.reproj_filter_px, cfg.min_views)

        X, valid, g2 = tri()
        stage["triangulate_filter"] += wall_ms(tri, reps=3)
        mask = g2.obs_mask & valid[None, :]
        if int(torch.sum(torch.sum(mask, 0) >= cfg.min_views)) >= 12:
            window = ba_mod.BAWindow(poses=poses0, points=X, obs_uv=g2.obs_uv, obs_mask=mask, K=Kt)
            ms = wall_ms(lambda: ba_mod.run_ba(window, cfg.ba), reps=3)
            run_ba_ms.append(ms)
            stage["run_ba"] += ms
            res = ba_mod.run_ba(window, cfg.ba)
            new = res.poses.cpu().numpy().astype(np.float64)
            cost_ok = float(res.final_cost) <= float(res.initial_cost) and np.isfinite(float(res.final_cost))
            obs = np.asarray(d["kw"]["marker_corners"], np.float64)[kf_idx[sl]]
            L = d["kw"]["real_marker_length"]

            def gates():
                mb = refine._marker_reproj_err(refined[sl], np.asarray(K, np.float64), obs, L)
                ma = refine._marker_reproj_err(new, np.asarray(K, np.float64), obs, L)
                return refine._gate(new, refined[sl], cost_ok, mb, ma, cfg)

            stage["gates"] += wall_ms(gates, reps=3)
            if gates()[0]:
                refined[sl] = new
            start += max(W - 2, 1)
        else:
            start += W - 2
    out = {"stage_ms": stage, "run_ba_ms_per_window": run_ba_ms}
    out["refine_trajectory_ms"] = wall_ms(lambda: refine.refine_trajectory(*d["args"], **d["kw"]), reps=3)
    # torch.profiler over run_ba on the last window that ran.
    prof, events = device_profile(lambda: ba_mod.run_ba_eager(window, cfg.ba), runs=2, top=10)
    out["run_ba_profile"] = dict(prof, top_aten_ops_per_run=top_aten_ops(events, runs=2))
    return out


def stream_sequence():
    """The stream phase's sequence: the loop at STREAM_FRAMES frames, the
    marker kept on its first and last 8 frames only."""
    from droplet_visual_odometry_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    seq = synthetic.render_sequence(synthetic.SyntheticConfig(**dict(LOOP_SEQ_CONFIG, n_frames=STREAM_FRAMES)))
    seq.marker_present[MARKER_KEEP:-MARKER_KEEP] = False
    seq.marker_corners[MARKER_KEEP:-MARKER_KEEP] = np.nan
    log(f"rendered the stream sequence {seq.frames.shape} in {time.perf_counter() - t0:.1f} s; "
        f"{4 * seq.frames.size / 2**30:.3f} GiB as float32")
    return seq


class Interrupted(Exception):
    pass


def streamed_run(seq, out_dir, ckpt, stop_after=None) -> tuple:
    """run_experiment(backend="pose_graph", stream=None) with a checkpoint
    path: it must take the streaming path. Spies on the chunk loop to time
    each chunk and read the card's peak memory after it; stop_after=k
    raises Interrupted from chunk k's progress call, which comes before that
    chunk's save (as in the reference), so k - 1 chunks stay saved. Returns
    (result, per-chunk records, the streaming call's keywords)."""
    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig

    real = pipeline.run_sequence_checkpointed
    calls, chunks = [], []
    t_last = [0.0]

    def on_chunk(done, n):
        now = time.perf_counter()
        chunks.append(dict(done=done, wall_ms=(now - t_last[0]) * 1e3,
                           peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        torch.cuda.reset_peak_memory_stats()
        t_last[0] = now
        if stop_after is not None and len(chunks) == stop_after:
            raise Interrupted

    def spy(*a, **kw):
        calls.append(kw)
        torch.cuda.reset_peak_memory_stats()
        t_last[0] = time.perf_counter()
        return real(*a, progress=on_chunk, **kw)

    pipeline.run_sequence_checkpointed = spy
    try:
        res = pipeline.run_experiment(seq, VOConfig(scale_mode="hold"), out_dir, SEED, backend="pose_graph",
                                      checkpoint_path=ckpt, checkpoint_chunk=STREAM_CHUNK, device="cuda")
    finally:
        pipeline.run_sequence_checkpointed = real
    return res, chunks, calls


def phase_stream(seq, results) -> dict:
    """The shipped default at a depth where streaming switches on by itself:
    STREAM_FRAMES frames at 1440x1080 (over 2 GiB as float32) written to a
    VOSTORE1 file and read back through StoreReader(...).frames();
    run_experiment(backend="pose_graph", stream=None, a checkpoint path,
    chunk 256): 2 chunks, the second padded. Checks the switch, the launch
    counters, the match counts against an in-memory run of the same frames,
    a run interrupted in chunk 2 (chunk 1 saved) and resumed against the
    uninterrupted one, the ATE against the JAX package's streamed run; then each kernel
    at the chunk shapes against its twin, the anatomy of one chunk (store
    read into the page-locked buffer, host-to-device copy, compute) and the
    warm streamed VO rate."""
    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.backend import refine
    from droplet_visual_odometry_tpu_torch.data import native_store
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig, run_sequence
    from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch
    from droplet_visual_odometry_tpu_torch.utils import checkpoint

    n = len(seq)
    if not 4 * seq.frames.size > pipeline.STREAM_BYTES:
        raise AssertionError("the stream sequence does not exceed the streaming threshold")
    if not native_store.native_available():
        raise AssertionError("the native store library is not available")
    n_chunks = -(-(n - 1) // STREAM_CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frames.vost")
        t0 = time.perf_counter()
        native_store.write_store(path, seq.frames, seq.timestamps)
        log(f"wrote {os.path.getsize(path) / 1e9:.3f} GB VOSTORE1 in {time.perf_counter() - t0:.2f} s")
        with native_store.StoreReader(path) as reader:
            if not np.array_equal(reader.timestamps(), seq.timestamps):
                raise AssertionError("store timestamps differ")
            sseq = dataclasses.replace(seq, frames=reader.frames())

            reset_launches()
            ckpt = os.path.join(tmp, "state.npz")
            out_dir = os.path.join(tmp, "out")
            with recording_optimize() as seen_graphs:
                t0 = time.perf_counter()
                res, chunks, calls = streamed_run(sseq, out_dir, ckpt)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
            launches = read_launches()
            check_run_outputs(res, out_dir, n)
            state = checkpoint.load_state(ckpt)
            log(f"streamed run_experiment: {wall_s:.2f} s whole (cold); kernel launches {launches}; chunks "
                f"{json.dumps(chunks)}")
            if len(calls) != 1 or calls[0]["chunk"] != STREAM_CHUNK or len(chunks) != n_chunks:
                raise AssertionError(f"the streaming switch did not fire as expected: {calls}, {len(chunks)} chunks")
            if int(state["next_start"]) != n or int(state["n_total"]) != n:
                raise AssertionError(f"checkpoint state {dict((k, state[k]) for k in ('next_start', 'n_total'))}")
            # Every chunk, the padded last one included, replays one captured program.
            n_levels = VOConfig().n_levels
            want = (CAPTURE_TICKS + 1) * n_levels
            if launches["fast_score"] != want or launches["orb_describe"] != want:
                raise AssertionError(f"expected {want} FAST and describe launches (one per level: the chunks' "
                                     f"captured VO program, then the keyframe stack op by op), got {launches}")
            if launches["hamming_match"] < 2 * CAPTURE_TICKS + 1:
                raise AssertionError(f"expected >= {2 * CAPTURE_TICKS + 1} match launches, got {launches}")
            if launches["pose_graph_pcg"] != CAPTURE_TICKS or len(seen_graphs) != 1:
                raise AssertionError(f"expected one pose graph and {CAPTURE_TICKS} PCG launches, got "
                                     f"{len(seen_graphs)} and {launches}")
            info = res.backend_info
            log(f"backend info {json.dumps(info)}")
            if info["n_loop_edges"] < 1 or not info["pg_final_cost"] < info["pg_initial_cost"]:
                raise AssertionError("no loop edge, or the pose-graph cost did not fall")

            # Interrupted in chunk 2's progress call (chunk 1 saved, chunk 2 not), then resumed.
            ckpt2 = os.path.join(tmp, "state2.npz")
            try:
                streamed_run(sseq, None, ckpt2, stop_after=2)
                raise AssertionError("the interrupted run was not interrupted")
            except Interrupted:
                pass
            if int(checkpoint.load_state(ckpt2)["next_start"]) != STREAM_CHUNK + 1:
                raise AssertionError("the interrupted run did not save its first chunk")
            resumed, resumed_chunks, _ = streamed_run(sseq, None, ckpt2)
            if len(resumed_chunks) != n_chunks - 1:
                raise AssertionError(f"the resumed run ran {len(resumed_chunks)} chunks")
            for f in type(res.trajectory)._fields:
                if not np.array_equal(getattr(res.trajectory, f), getattr(resumed.trajectory, f)):
                    raise AssertionError(f"resumed trajectory field {f} differs from the uninterrupted run")
            pose_diff = float(np.abs(resumed.vo_abs - res.vo_abs).max())
            log(f"resumed run: VO trajectory equal bit for bit to the uninterrupted run; refined poses differ by "
                f"{pose_diff:.3e} (the pose graph's index_add_ sums in no fixed order on the card)")
            if pose_diff > RESUME_POSE_TOL or resumed.backend_info["loop_pairs"] != info["loop_pairs"]:
                raise AssertionError("the resumed run's refined poses or loop pairs differ")

            # The same frames in memory on the card.
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            mem = pipeline.run_experiment(seq, VOConfig(scale_mode="hold"), None, SEED, backend="pose_graph",
                                          stream=False, device="cuda")
            torch.cuda.synchronize()
            mem_s = time.perf_counter() - t0
            nm_s, nm_m = res.trajectory.n_matches, mem.trajectory.n_matches
            differ = int((nm_s != nm_m).sum())
            dev = np.abs(nm_s - nm_m).sum() / nm_m.sum()
            log(f"in-memory run_experiment {mem_s:.2f} s, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
                f"n_matches streamed vs in memory: {n - 1 - differ}/{n - 1} pairs equal, total deviation {dev:.5f}"
                f"; ATE in memory {mem.ate.rmse!r} m")
            if dev > MATCH_TOL:
                raise AssertionError(f"streamed match counts deviate {dev:.4f} from the in-memory run's")
            total_dev = abs(int(nm_s.sum()) - JAX_STREAM_N_MATCHES) / JAX_STREAM_N_MATCHES
            log(f"streamed n_matches total {int(nm_s.sum())} (JAX package {JAX_STREAM_N_MATCHES}, deviation "
                f"{total_dev:.5f}); pairs ok {float(np.mean(res.trajectory.ok)):.4f}")
            if total_dev > MATCH_TOL:
                raise AssertionError(f"streamed match count total deviates {total_dev:.4f} from the JAX package's")
            log(f"stream ATE rmse {res.ate.rmse!r} m (JAX package {JAX_STREAM_ATE_RMSE} +- {STREAM_ATE_TOL}); "
                f"RPE {res.rpe.trans_rmse!r} m / {res.rpe.rot_rmse_deg!r} deg")
            if abs(res.ate.rmse - JAX_STREAM_ATE_RMSE) > STREAM_ATE_TOL:
                raise AssertionError(f"stream ATE {res.ate.rmse} outside {JAX_STREAM_ATE_RMSE} +- {STREAM_ATE_TOL}")

            # Warm streamed VO (no checkpoint file), frames from the store.
            preprocess = pipeline.make_preprocessor(sseq, "cuda")
            K = pipeline.effective_K(seq).astype(np.float32)
            corners = pipeline.effective_marker_corners(seq, K)
            vo_args = (sseq.frames, corners, seq.marker_present, np.asarray(seq.marker_poses[0], np.float32), K,
                       seq.real_marker_length, VOConfig(scale_mode="hold"))
            warm_ms = wall_ms(lambda: checkpoint.run_sequence_checkpointed(
                *vo_args, path=None, chunk=STREAM_CHUNK, seed=SEED, preprocess=preprocess, device="cuda"), reps=2)
            log(f"streamed VO warm: {warm_ms:.2f} ms for {n} frames = {(n - 1) / warm_ms * 1e3:.2f} frames/s")

            # One chunk's anatomy: store read into the page-locked buffer, copy to the card, compute.
            staging = torch.empty((STREAM_CHUNK + 1,) + seq.frames.shape[1:], dtype=torch.uint8, pin_memory=True)
            host = staging.numpy()

            def stage():
                host[:] = sseq.frames[0 : STREAM_CHUNK + 1]

            read_ms = wall_ms(stage, reps=3)
            h2d_ms = call_ms(lambda: staging.to("cuda", non_blocking=True), reps=5, warmup=1)
            raw = staging.to("cuda")
            chunk_args = (corners[: STREAM_CHUNK + 1], seq.marker_present[: STREAM_CHUNK + 1], vo_args[3], K,
                          seq.real_marker_length, VOConfig(scale_mode="hold"))
            compute_ms = wall_ms(lambda: run_sequence(preprocess(raw), *chunk_args, seed=SEED), reps=3)
            log(f"one chunk of {STREAM_CHUNK} pairs: store read into the page-locked buffer {read_ms:.2f} ms, "
                f"host-to-device copy {h2d_ms:.2f} ms ({staging.numel() / h2d_ms / 1e6:.2f} GB/s), compute "
                f"(preprocess + run_sequence) {compute_ms:.2f} ms")

            # The kernels at the chunk shapes.
            chunk_frames = preprocess(raw)
            fast_c, desc_c = frontend_levels(chunk_frames, VOConfig().n_keypoints, "stream chunk")
            feats = detect_and_describe_batch(chunk_frames, k=VOConfig().n_keypoints)
            chunk_match = match_case("stream chunk", feats.desc[:-1], feats.desc[1:], feats.valid[:-1],
                                     feats.valid[1:])
            results["fast_score"]["stream_chunk"] = frontend_row(fast_c)
            results["orb_describe"]["stream_chunk"] = frontend_row(desc_c)
            results["hamming_match"]["stream_chunk"] = chunk_match
            results["pose_graph_pcg"]["stream_run"] = pcg_case("stream run", seen_graphs[0],
                                                               refine.PoseGraphRefineConfig().pg)
            del raw, chunk_frames, feats
    return dict(launches=launches, ate_rmse=res.ate.rmse, info=info, wall_s=wall_s, chunks=chunks,
                in_memory_s=mem_s, match_pairs_differ=differ, warm_ms=warm_ms, read_ms=read_ms, h2d_ms=h2d_ms,
                compute_ms=compute_ms, resumed_pose_diff=pose_diff, result=res)


def timed_program_call(call, programs: list) -> tuple[object, float]:
    """call() with CUDA events around every replay of `programs` in it:
    (its result, the summed device span of those replays in ms)."""
    events, graphs_ = [], [(p, p.graph) for p in programs]

    def timed(graph):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))

    for p, g in graphs_:
        p.graph = types.SimpleNamespace(replay=lambda g=g: timed(g), reset=g.reset)
    try:
        out = call()
    finally:
        for p, g in graphs_:
            p.graph = g
    torch.cuda.synchronize()
    return out, float(sum(start.elapsed_time(end) for start, end in events))


def program_row(label: str, graphed, eager, check, reps: int = 5) -> dict:
    """One program of phase G: graphed() captures it (the first call) and
    replays it; eager() is its twin op by op; check(graph_out, eager_out)
    raises on a disagreement and returns the largest difference. Records
    capture wall, first-call wall, replay wall (median of `reps`
    synchronised calls: staging, replay, output clones), eager wall, the
    replay's device span (CUDA events around graph.replay(), median of
    `reps` calls), the graph memory and the launches captured."""
    from droplet_visual_odometry_tpu_torch.utils import graphs

    before = {id(p) for p in graphs.programs()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = graphed()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    new = [p for p in graphs.programs() if id(p) not in before]
    if not new:
        raise AssertionError(f"{label}: no program was captured")
    ref = eager()
    torch.cuda.synchronize()
    diff = check(out, ref)
    replay_ms = wall_ms(graphed, reps=reps)
    eager_ms = wall_ms(eager, reps=3)
    spans = [timed_program_call(graphed, new)[1] for _ in range(reps)]
    launches = {k: sum(p.captured_launches[k] for p in new) for k in new[0].captured_launches}
    row = dict(capture_s=sum(p.capture_s for p in new), first_call_ms=first_ms, replay_ms=replay_ms,
               eager_ms=eager_ms, device_span_ms=float(np.median(spans)),
               graph_memory_gb=sum(p.memory_bytes for p in new) / 1e9, captured_launches=launches,
               programs=len(new), max_diff=diff)
    log(f"G {label}: capture {row['capture_s']:.3f} s ({len(new)} program(s), {row['graph_memory_gb']:.3f} GB, "
        f"launches captured {launches}); first call {first_ms:.2f} ms; replay {replay_ms:.3f} ms against eager "
        f"{eager_ms:.3f} ms; device span {row['device_span_ms']:.3f} ms; replay vs eager max diff {diff!r}")
    return row


def eager_call_row(label: str, fn, reps: int = 7) -> dict:
    """A call the port runs op by op, weighed for capture as a program:
    its synchronised wall (median and spread, max - min, of `reps` calls
    after two), the CUDA kernels it launches and their device time a call
    (torch.profiler over 3 calls), and the span between CUDA events around
    it. A graph could save at most wall - device time; capturing pays only
    where that exceeds the spread."""
    for _ in range(2):
        fn()
    walls, spans = [], []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        spans.append(start.elapsed_time(end))
    prof, _ = device_profile(fn, runs=3, top=3)
    row = dict(wall_ms=float(np.median(walls)), wall_spread_ms=max(walls) - min(walls),
               event_span_ms=float(np.median(spans)), kernels=prof["kernels_per_run"],
               device_busy_ms=prof["device_busy_ms_per_run"], top_kernels=prof["top_kernels_ms_per_run"])
    row["host_ms_a_graph_could_save"] = row["wall_ms"] - row["device_busy_ms"]
    row["capture_could_pay"] = row["host_ms_a_graph_could_save"] > row["wall_spread_ms"]
    log(f"G op by op, {label}: wall {row['wall_ms']:.4f} ms (spread {row['wall_spread_ms']:.4f}), "
        f"{row['kernels']:.0f} kernels, device busy {row['device_busy_ms']:.4f} ms, event span "
        f"{row['event_span_ms']:.4f} ms; a graph could save at most {row['host_ms_a_graph_could_save']:.4f} ms")
    return row


def ba_kernel_case(label: str, window, cfg) -> dict:
    """The windowed BA kernel on one real float64 window: run_ba (one launch
    of csrc/windowed_ba.cu) within GRAPH_TOL of run_ba_eager on the card
    (poses, points, final cost), two launches bit for bit; its device time
    (device_ms) and one call with its launch (call_ms), against the captured
    op-by-op program it replaces (run_ba_graph: device time with its input
    staging and output clones, and one call) and the eager twin's wall,
    beside its bound: the Schur product (108 FMA a landmark and pose pair
    w <= v), about 460 FLOPs an observation for its blocks and a
    (6W)^3 / 3 solve, cfg.iters steps at the float64 rate, or the inputs
    read and the outputs written once at 3.35 TB/s."""
    from droplet_visual_odometry_tpu_torch.backend import ba
    from droplet_visual_odometry_tpu_torch.ops import cuda_ba

    W, L = (int(x) for x in window.obs_mask.shape)
    before = cuda_ba.LAUNCHES
    out = ba.run_ba(window, cfg)
    launches = cuda_ba.LAUNCHES - before
    again = ba.run_ba(window, cfg)
    diff = within(GRAPH_TOL, "poses", "points", "final_cost")(out, ba.run_ba_eager(window, cfg))
    case = dict(window=[W, L], blocks=cuda_ba.plan(W, L), launches=launches, max_diff_eager=diff,
                repeats_bit_for_bit=all(torch.equal(a, b) for a, b in zip(out, again)),
                cost=[float(out.initial_cost), float(out.final_cost)])
    case["ms"] = device_ms(lambda: ba.run_ba(window, cfg))
    case["call_ms"] = call_ms(lambda: ba.run_ba(window, cfg))
    case["graph_ms"] = device_ms(lambda: ba.run_ba_graph(window, cfg), reps=5)
    case["graph_call_ms"] = call_ms(lambda: ba.run_ba_graph(window, cfg), reps=5)
    case["eager_ms"] = wall_ms(lambda: ba.run_ba_eager(window, cfg), reps=3)
    n = 6 * W
    ops = cfg.iters * (L * W * (W + 1) // 2 * 216 + W * L * 460 + n ** 3 / 3)
    bytes_moved = sum(t.numel() * t.element_size() for t in window) + (W * 16 + L * 3 + 3) * 8
    case.update(roof(bytes_moved, ops, F64_OPS_PER_S))
    case["share"] = case["bound_ms"] / case["ms"]
    log(f"windowed BA kernel, {label} window (W = {W}, L = {L}) on {case['blocks']} blocks: kernel {case['ms']:.4f} ms "
        f"(one call {case['call_ms']:.4f}), the captured op program {case['graph_ms']:.4f} ms (one call "
        f"{case['graph_call_ms']:.4f}), eager {case['eager_ms']:.2f} ms; bound {case['bound_ms']:.6f} ms "
        f"({case['bound_by']}, share {case['share']:.2e}); {launches} launch(es); vs eager {diff:.3e}; repeat bit for "
        f"bit {case['repeats_bit_for_bit']}; cost {case['cost']}")
    if launches != 1 or not case["repeats_bit_for_bit"]:
        raise AssertionError(f"windowed BA kernel, {label} window: {launches} launches, repeat bit for bit "
                             f"{case['repeats_bit_for_bit']}")
    return case


def equal_fields(a, b) -> float:
    """0.0 if every tensor field of a (or a itself, a tensor) equals b's bit
    for bit, else raise."""
    for name, x, y in zip(type(a)._fields, a, b) if hasattr(a, "_fields") else [("value", a, b)]:
        if not torch.equal(x, y):
            raise AssertionError(f"replay differs from the eager twin in {name}: "
                                 f"{float((x.double() - y.double()).abs().max())!r}")
    return 0.0


def within(tol: float, *fields: str):
    """check(a, b): the named fields within tol (absolute), the rest finite."""
    def check(a, b) -> float:
        d = max(float((getattr(a, f) - getattr(b, f)).abs().max()) for f in fields)
        if not d <= tol or not all(bool(torch.isfinite(t).all()) for t in a):
            raise AssertionError(f"replay differs from the eager twin by {d!r} (> {tol}) in {fields}")
        return d
    return check


def phase_graphs(seq, loop_seq, pg: dict, ba_run: dict, stream_seq) -> dict:
    """Phase G: the JAX package's four compiled programs as CUDA graphs
    (utils/graphs.py), each captured afresh and replayed at the main path's
    shapes and held against its eager twin: run_sequence on the bench
    workload (N = 24) and on a stream chunk (N = 257, the stream cell's
    first chunk) bit for bit; pose_graph.optimize on phase 5's padded graph
    (one GN step replayed per iteration) and run_ba_graph on phase 6's
    windows (the whole LM loop) within GRAPH_TOL, with refine_trajectory's
    accepted windows equal; loop-closure verification at phase 5's P = 128,
    K = 1024 bit for bit. Each row: capture wall, replay wall, eager wall,
    device span, graph memory, launches captured. Then the windowed BA
    kernel on every window of phase 6 and at the ba cell's shapes
    (ba_kernel_case), and op_by_op_rows."""
    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.backend import ba, loop_closure, pose_graph, refine
    from droplet_visual_odometry_tpu_torch.estimation import vo
    from droplet_visual_odometry_tpu_torch.utils import graphs, threefry

    t_phase = time.perf_counter()
    graphs.clear()
    rows = {}

    # run_sequence on the bench workload, VOConfig() and seed 0's key.
    frames = pipeline.make_preprocessor(seq, "cuda")(seq.frames)
    K = pipeline.effective_K(seq)
    corners = pipeline.effective_marker_corners(seq, K)
    args = (frames, corners, seq.marker_present, seq.marker_poses[0], K, seq.real_marker_length, vo.VOConfig())
    rows["run_sequence_bench"] = program_row(
        "run_sequence, bench workload (24 x 1440x1080)", lambda: vo.run_sequence(*args, seed=SEED),
        lambda: vo.run_sequence_eager(*args, seed=SEED), equal_fields)
    del frames

    # run_sequence on the stream cell's first chunk, as run_sequence_checkpointed runs it.
    n = STREAM_CHUNK + 1
    chunk = pipeline.make_preprocessor(stream_seq, "cuda")(stream_seq.frames[:n])
    Ks = pipeline.effective_K(stream_seq)
    cs = pipeline.effective_marker_corners(stream_seq, Ks)[:n]
    key = threefry.fold_in(threefry.prng_key(SEED, "cuda"), 1)
    cargs = (chunk, cs, stream_seq.marker_present[:n], stream_seq.marker_poses[0], Ks, stream_seq.real_marker_length,
             vo.VOConfig(scale_mode="hold"))
    rows["run_sequence_chunk"] = program_row(
        f"run_sequence, stream chunk ({n} x 1440x1080)", lambda: vo.run_sequence(*cargs, init_scale=1.0, key=key),
        lambda: vo.run_sequence_eager(*cargs, init_scale=1.0, key=key), equal_fields, reps=3)
    del chunk
    graphs.clear()

    d = pg["inputs"]

    # pose_graph.optimize on phase 5's padded graph, one GN step a replay.
    graph, cfg_pg = pg["graph"], pg["inputs"]["cfg"].pg
    pg_check = within(GRAPH_TOL, "poses", "final_cost")
    shape = (f"{tuple(graph.poses.shape)[0]} nodes, {graph.edge_i.shape[0]} edges, {cfg_pg.iters} GN x "
             f"{cfg_pg.cg_iters} CG steps")
    rows["optimize"] = program_row(
        f"pose_graph.optimize, one GN step a replay ({shape})", lambda: pose_graph.optimize(graph, cfg_pg),
        lambda: pose_graph.optimize_eager(graph, cfg_pg), pg_check)

    # pose_graph_trajectory through the graph against the same call op by op.
    pga = (d["frames"], d["vo_abs"], d["traj"].n_inliers, d["corners"], loop_seq.marker_present, d["K"], d["L"],
           vo.VOConfig(scale_mode="hold"), d["cfg"])
    traj_g, info_g = refine.pose_graph_trajectory(*pga, pair_scale_ok=d["traj"].scale_ok)
    with eager_programs():
        traj_e, info_e = refine.pose_graph_trajectory(*pga, pair_scale_ok=d["traj"].scale_ok)
    pgt_diff = float(np.abs(traj_g - traj_e).max())
    if info_g["loop_pairs"] != info_e["loop_pairs"] or pgt_diff > GRAPH_TOL:
        raise AssertionError(f"pose_graph_trajectory graphed vs eager: loop pairs {info_g['loop_pairs']} vs "
                             f"{info_e['loop_pairs']}, poses {pgt_diff}")
    pgt_ms = wall_ms(lambda: refine.pose_graph_trajectory(*pga, pair_scale_ok=d["traj"].scale_ok), reps=3)
    with eager_programs():
        pgt_eager_ms = wall_ms(lambda: refine.pose_graph_trajectory(*pga, pair_scale_ok=d["traj"].scale_ok), reps=3)
    log(f"G pose_graph_trajectory: {pgt_ms:.2f} ms through the graphs, {pgt_eager_ms:.2f} ms op by op; loop pairs "
        f"equal, refined poses {pgt_diff:.3e} apart")
    graphs.clear()

    # run_ba on phase 6's windows (each (W, L) signature is one program), then refine_trajectory's gates.
    windows = recorded_ba_windows(ba_run)
    graphs.clear()
    ba_check = within(GRAPH_TOL, "poses", "points", "final_cost")
    sigs = {}
    for w, cfg_ba in windows:
        sigs.setdefault((tuple(w.poses.shape), tuple(w.points.shape)), (w, cfg_ba))
    ba_rows = []
    for (wshape, lshape), (w, cfg_ba) in sigs.items():
        label = f"W = {wshape[0]}, L = {lshape[0]}"
        ba_rows.append(dict(window=label, loop=program_row(
            f"run_ba_graph, the whole LM loop ({label}, {cfg_ba.iters} steps)", lambda: ba.run_ba_graph(w, cfg_ba),
            lambda: ba.run_ba_eager(w, cfg_ba), ba_check)))
    per_window = [ba_check(ba.run_ba(w, c), ba.run_ba_eager(w, c)) for w, c in windows]
    cell_windows = recorded_ba_windows(ba_run, dataclasses.replace(refine.RefineConfig(), n_keypoints=1000))
    kernel_rows = [ba_kernel_case(label, *cell_windows[i]) for label, i in (("first", 0), ("last", -1))]
    bd = ba_run["inputs"]
    ref_g, info_bg = refine.refine_trajectory(*bd["args"], **bd["kw"])
    with eager_programs():
        ref_e, info_be = refine.refine_trajectory(*bd["args"], **bd["kw"])
    ref_diff = float(np.abs(ref_g - ref_e).max())
    if accepted_windows(info_bg) != accepted_windows(info_be) or ref_diff > GRAPH_TOL:
        raise AssertionError(f"refine_trajectory graphed vs eager: accepted {accepted_windows(info_bg)} vs "
                             f"{accepted_windows(info_be)}, poses {ref_diff}")
    rt_ms = wall_ms(lambda: refine.refine_trajectory(*bd["args"], **bd["kw"]), reps=3)
    with eager_programs():
        rt_eager_ms = wall_ms(lambda: refine.refine_trajectory(*bd["args"], **bd["kw"]), reps=3)
    log(f"G run_ba on {len(windows)} windows: each within {max(per_window):.3e} of its eager twin; "
        f"refine_trajectory {rt_ms:.2f} ms through the graphs, {rt_eager_ms:.2f} ms op by op; accepted windows "
        f"{accepted_windows(info_bg)} both ways, refined poses {ref_diff:.3e} apart")
    graphs.clear()

    # Verification at phase 5's shapes: R restarts x n_slot slots, K = 1024.
    feats, lc = pg["feats"], d["lc"]
    kf = d["kf_idx"]
    ca, cb, _ = loop_closure._candidate_pairs(feats, d["n_kf"], lc, d["extra"])
    R, n_slot = max(1, lc.verify_restarts), loop_closure.verify_slots(len(ca), lc)
    ca_p, cb_p = loop_closure._restart_layout(ca, cb, n_slot, R)
    corners_kf = torch.nan_to_num(torch.as_tensor(d["corners"][kf], device="cuda"))
    mvalid = torch.as_tensor(loop_seq.marker_present[kf], device="cuda")
    Kt = torch.as_tensor(d["K"], device="cuda")
    vcfg = loop_closure._verify_vo_config(vo.VOConfig(scale_mode="hold"), lc)
    draws = loop_closure.reference_draws(R * n_slot, vcfg.ransac, 0, Kt.device)
    vargs = (feats, corners_kf, mvalid, Kt, d["L"], vcfg, ca_p, cb_p, *draws)
    rows["verify"] = program_row(
        f"loop-closure verification (P = {R * n_slot}, K = {feats.desc.shape[1]})",
        lambda: loop_closure._verify_candidates(*vargs), lambda: loop_closure._verify_candidates_eager(*vargs),
        equal_fields)
    graphs.clear()
    rows["op_by_op"] = op_by_op_rows(seq, stream_seq, feats, d)
    wall = time.perf_counter() - t_phase
    log(f"G: phase G {wall:.1f} s")
    return dict(rows, run_ba=ba_rows, run_ba_windows=len(windows), run_ba_max_diff=max(per_window),
                windowed_ba=kernel_rows,
                pose_graph_trajectory=dict(graph_ms=pgt_ms, eager_ms=pgt_eager_ms, max_diff=pgt_diff),
                refine_trajectory=dict(graph_ms=rt_ms, eager_ms=rt_eager_ms, max_diff=ref_diff,
                                       accepted=accepted_windows(info_bg)), wall_s=wall)


def op_by_op_rows(seq, stream_seq, feats, d: dict) -> dict:
    """The JAX package's other jitted device calls, which the port runs op
    by op, weighed at the main path's shapes (eager_call_row): retrieval on
    phase 5's keyframe features (global descriptors, the similarity
    product, the match counts of the shortlisted pairs), ground truth from
    the stream cell's 400 frames of detections, and the preprocessor's cast
    and undistortion remap on the bench workload's 24 raw frames already on
    the card (the remap with distorted_1440's lens)."""
    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.backend import loop_closure
    from droplet_visual_odometry_tpu_torch.core import camera, se3
    from droplet_visual_odometry_tpu_torch.groundtruth import derive_ground_truth, detections_from_arrays

    lc, n_kf = d["lc"], d["n_kf"]
    g = loop_closure.global_descriptors(feats.desc, feats.valid)
    ia, ib = loop_closure._shortlist_pairs(feats, n_kf, lc.min_gap, lc.shortlist)
    t, q = se3.to_translation_quaternion(torch.as_tensor(stream_seq.marker_poses, dtype=torch.float32))
    n = len(stream_seq)
    dets = detections_from_arrays(np.zeros((n, 1), np.int32), t.numpy()[:, None], q.numpy()[:, None],
                                  np.nan_to_num(stream_seq.marker_corners)[:, None])
    dets = type(dets)(*(a.cuda() for a in dets))
    raw = torch.as_tensor(seq.frames, device="cuda")
    lens = camera.make_camera(1173.854081, 1170.565083, 747.788206, 574.700374,
                              dist=[-0.296079, 0.099771, 0.000222, 0.000109, 0.0], width=1440, height=1080)
    cast = pipeline.make_preprocessor(seq, "cuda")
    remap = pipeline.make_preprocessor(dataclasses.replace(seq, camera=lens), "cuda")
    calls = {
        f"global_descriptors ({n_kf} keyframes, K = {feats.desc.shape[1]})":
            lambda: loop_closure.global_descriptors(feats.desc, feats.valid),
        f"global_similarity ({n_kf} x {g.shape[1]})": lambda: loop_closure.global_similarity(g),
        f"_retrieval_counts (P = {len(ia)} shortlisted pairs)":
            lambda: loop_closure._retrieval_counts(feats.desc, feats.valid, ia, ib, lc.match_max_distance),
        f"derive_ground_truth ({n} frames)": lambda: derive_ground_truth(dets, 0),
        f"preprocessor, cast ({len(seq)} x 1440x1080 uint8 on the card)": lambda: cast(raw),
        f"preprocessor, cast and undistortion remap ({len(seq)} x 1440x1080)": lambda: remap(raw),
    }
    return {label: eager_call_row(label, fn) for label, fn in calls.items()}


class eager_programs:
    """Within: optimize, run_ba and verification run their eager twins (the
    backends op by op; the pose graph's CG runs in its kernel either way),
    for the like-for-like comparisons of phase G."""

    def __enter__(self):
        from droplet_visual_odometry_tpu_torch.backend import ba, loop_closure, pose_graph

        self.saved = (pose_graph.optimize, ba.run_ba, loop_closure._verify_candidates)
        pose_graph.optimize = pose_graph.optimize_eager
        ba.run_ba = ba.run_ba_eager
        loop_closure._verify_candidates = loop_closure._verify_candidates_eager

    def __exit__(self, *exc):
        from droplet_visual_odometry_tpu_torch.backend import ba, loop_closure, pose_graph

        pose_graph.optimize, ba.run_ba, loop_closure._verify_candidates = self.saved


def bag_fixture():
    """tests/torch_bag_data.py, the jax-free bag writer the CPU tests use,
    loaded from this checkout."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_bag_data.py")
    spec = importlib.util.spec_from_file_location("torch_bag_data", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class timed_calls:
    """Replace module functions by wrappers that add each call's host wall
    (seconds) to `walls[label]`; restored on exit."""

    def __init__(self, walls: dict, targets: dict):
        self.walls, self.targets, self.saved = walls, targets, []

    def __enter__(self):
        for label, (mod, name) in self.targets.items():
            real = getattr(mod, name)

            def spy(*a, _real=real, _label=label, **kw):
                t0 = time.perf_counter()
                try:
                    return _real(*a, **kw)
                finally:
                    self.walls[_label] = self.walls.get(_label, 0.0) + time.perf_counter() - t0

            setattr(mod, name, spy)
            self.saved.append((mod, name, real))
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def run_cli(main, argv: list[str], capture_run: bool = False) -> tuple[list[dict], float, object]:
    """Run a CLI's main(argv) in this process: (the JSON objects it printed,
    its wall in s, the ExperimentResult of its pipeline.run_experiment call
    if capture_run)."""
    import contextlib
    import io

    from droplet_visual_odometry_tpu_torch import pipeline

    real, got = pipeline.run_experiment, []

    def spy(*a, **kw):
        got.append(real(*a, **kw))
        return got[-1]

    buf = io.StringIO()
    if capture_run:
        pipeline.run_experiment = spy
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pipeline.run_experiment = real
    if rc != 0:
        raise AssertionError(f"{main.__module__} {argv} exited {rc}")
    text, dec, docs = buf.getvalue(), json.JSONDecoder(), []
    i = text.find("{")
    while i >= 0:
        doc, end = dec.raw_decode(text, i)
        docs.append(doc)
        i = text.find("{", end)
    return docs, wall, (got[0] if got else None)


def tum_ate_tolerance(tum, out_dir: str, res) -> float:
    """How far analyze's ATE, computed from the TUM files, may lie from the
    same ATE of the run's float64 poses `res` (an ExperimentResult), to
    first order: the file holds each pose as float32 values and its rotation
    as a unit quaternion, so (a) a rotation that drifted from orthonormal in
    the run's float32 pose chain is stored orthonormalised: max over poses
    of |R^T R - I| * |t|; and (b) analyze rebuilds and inverts the poses in
    float32: TUM_ATE_ULPS * eps32 * max of cond(T) * |camera centre|, over
    both absolute streams."""
    worst = 0.0
    for name in ("stamped_ground_truth_absolute.txt", "stamped_traj_estimate_absolute.txt"):
        _, poses = tum.read_tum(os.path.join(out_dir, name))
        P = poses.astype(np.float64)
        centres = np.linalg.norm(np.linalg.inv(P)[:, :3, 3], axis=1)
        worst = max(worst, float((np.linalg.cond(P) * np.maximum(centres, 1.0)).max()))
    drift = 0.0
    for P in (res.gt_abs, res.vo_abs):
        R, t = np.asarray(P, np.float64)[:, :3, :3], np.asarray(P, np.float64)[:, :3, 3]
        dev = np.linalg.norm(np.swapaxes(R, 1, 2) @ R - np.eye(3), ord=2, axis=(1, 2))
        drift = max(drift, float((dev * np.maximum(np.linalg.norm(t, axis=1), 1.0)).max()))
    return drift + TUM_ATE_ULPS * float(np.finfo(np.float32).eps) * worst


def head(seq, n: int):
    """The first n frames of a sequence."""
    return dataclasses.replace(seq, frames=seq.frames[:n], timestamps=seq.timestamps[:n],
                               marker_corners=seq.marker_corners[:n], marker_poses=seq.marker_poses[:n],
                               marker_present=seq.marker_present[:n], marker_ids=seq.marker_ids[:n], gt_poses=None)


def check_small_bags(bags, seq, tmp: str) -> dict:
    """8 frames of the stream sequence as bags with none, bz2 and lz4 chunks
    (mono8 frames with rgb8 and bgr8 ones among them): extract_bag gives the
    same arrays for all three, the rgb frames their BT.601 luma; and as
    PNG CompressedImage messages (cv2 decodes them), the frames themselves."""
    from droplet_visual_odometry_tpu_torch.data import rosbag

    small = head(seq, INGEST_SMALL_FRAMES)
    enc = list(INGEST_SMALL_ENCODINGS)
    out, first = {}, None
    for comp in ("none", "bz2", "lz4"):
        path = os.path.join(tmp, f"small_{comp}.bag")
        bags.sequence_bag(path, small, comp, encodings=enc)
        t0 = time.perf_counter()
        got = rosbag.extract_bag(path, bags.IMG_TOPIC, bags.MARKER_TOPIC)
        out[comp] = dict(bytes=os.path.getsize(path), read_s=time.perf_counter() - t0)
        if first is None:
            first = got
            if not np.array_equal(got[0]["frames"], bags.expected_frames(small, enc)):
                raise AssertionError("small bag: frames differ from the sequence's (rgb frames: their luma)")
            if not np.array_equal(got[0]["timestamps"], bags.stored_stamps(small.timestamps)):
                raise AssertionError("small bag: stamps differ from the stored stamps")
        for a, b in zip(got, first):
            for k in b:
                if not np.array_equal(a[k], b[k], equal_nan=b[k].dtype.kind == "f"):
                    raise AssertionError(f"small bag {comp}: {k} differs from the uncompressed bag's")
    path = os.path.join(tmp, "small_png.bag")
    bags.sequence_bag(path, small, "none", compressed=True)
    if not np.array_equal(rosbag.extract_bag(path, bags.IMG_TOPIC, bags.MARKER_TOPIC)[0]["frames"], small.frames):
        raise AssertionError("small bag: PNG CompressedImage frames differ from the sequence's")
    log(f"small bags ({INGEST_SMALL_FRAMES} frames, {'/'.join(enc)}): none / bz2 / lz4 give equal arrays "
        f"({json.dumps(out)}); PNG CompressedImage frames equal")
    return out


def phase_ingest(seq, stream: dict, results) -> dict:
    """Phase I, ingest and the CLIs on the stream cell: the 400 rendered
    frames written as a ROS1 bag (mono8 images, one STag-style marker
    message a frame, the absent frames' messages a decoy of another id with
    the frame's pose), converted by cli.convert (--bag, ground truth on the
    card) and held against the rendered sequence; cli.run_experiment on the
    converted .npz with a checkpoint and 384 hypotheses (phase 7's config)
    held against phase 7's streamed run; cli.analyze on its TUM directory;
    then the synthetic source with --profile-dir against an in-process run,
    and the kernels at the debug images' shapes (a two-frame batch, the
    match at P = 1) against their twins."""
    from droplet_visual_odometry_tpu_torch import groundtruth, pipeline
    from droplet_visual_odometry_tpu_torch import convert as config_from
    from droplet_visual_odometry_tpu_torch.cli import analyze, convert, run_experiment
    from droplet_visual_odometry_tpu_torch.data import lz4f, native_store, rosbag, sequence, synthetic
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu_torch.eval import metrics, tum
    from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch
    from droplet_visual_odometry_tpu_torch.utils import checkpoint, profiling

    bags = bag_fixture()
    n = len(seq)
    phase7 = stream["result"]
    with tempfile.TemporaryDirectory() as tmp:
        small = check_small_bags(bags, seq, tmp)

        # The 400-frame bag, lz4 chunks where liblz4 is present.
        compression = "lz4" if lz4f.native_available() else "none"
        bag, calib = os.path.join(tmp, "run.bag"), os.path.join(tmp, "cam.yaml")
        t0 = time.perf_counter()
        bags.sequence_bag(bag, seq, compression)
        bag_write_s = time.perf_counter() - t0
        bags.write_calibration(calib, seq.camera)
        bag_mb = os.path.getsize(bag) / 1e6
        log(f"wrote a {n}-frame bag ({compression} chunks): {bag_mb:.1f} MB in {bag_write_s:.2f} s")

        # Convert, each step timed.
        npz, store = os.path.join(tmp, "seq.npz"), os.path.join(tmp, "seq.vost")
        walls = {}
        steps = {"bag_read_decode": (rosbag, "extract_bag"), "pairing": (native_store, "pair_stamps"),
                 "ground_truth": (groundtruth, "sequence_from_detections"), "npz_write": (sequence, "save"),
                 "vostore_write": (native_store, "write_store")}
        with timed_calls(walls, steps):
            _, convert_s, _ = run_cli(convert.main, [
                "--bag", bag, "--calibration", calib, "--marker-id", "0",
                "--marker-length", repr(seq.real_marker_length), "--camera-frame-detections",
                "--out", npz, "--vostore", store])
        if set(walls) != set(steps):
            raise AssertionError(f"convert did not go through every step: {sorted(walls)}")
        conv = sequence.load(npz)
        present = seq.marker_present
        stamp_err = float(np.abs(conv.timestamps - seq.timestamps).max())
        pose_err = float(np.abs(conv.marker_poses - seq.marker_poses).max())
        if not np.array_equal(conv.frames, seq.frames):
            raise AssertionError("converted frames differ from the rendered ones")
        if not np.array_equal(conv.timestamps, bags.stored_stamps(seq.timestamps)):
            raise AssertionError("converted timestamps differ from the bag's stored stamps")
        if not np.array_equal(conv.marker_present, present):
            raise AssertionError("converted marker_present differs")
        if not (np.array_equal(conv.marker_corners[present], seq.marker_corners[present])
                and np.isnan(conv.marker_corners[~present]).all()):
            raise AssertionError("converted corners differ where the marker is present, or are not NaN elsewhere")
        if pose_err > POSE_ROUND_TRIP_TOL:
            raise AssertionError(f"converted marker poses {pose_err} from the rendered ones")
        with native_store.StoreReader(store) as reader:
            if not (np.array_equal(reader.read(0, reader.n), seq.frames)
                    and np.array_equal(reader.timestamps(), conv.timestamps)):
                raise AssertionError("the VOSTORE1 file differs from the converted frames")
        log(f"converted {n} frames in {convert_s:.2f} s ({n / convert_s:.2f} frames/s): steps "
            f"{json.dumps({k: round(v, 4) for k, v in walls.items()})}; bag read and decode "
            f"{bag_mb / walls['bag_read_decode']:.1f} MB/s; frames byte-equal, stamps equal to the bag's "
            f"nanosecond stamps (at most {stamp_err:.3e} s from the rendered), marker_present and corners equal, "
            f"marker poses within {pose_err:.3e} (the quaternion round trip), the VOSTORE1 file equal")

        # run_experiment on the converted sequence: phase 7's configuration, streamed in 2 chunks.
        out_dir, ckpt = os.path.join(tmp, "out"), os.path.join(tmp, "state.npz")
        reset_launches()
        docs, cli_s, res = run_cli(run_experiment.main, [
            "--sequence", npz, "--out-dir", out_dir, "--checkpoint", ckpt,
            "--ransac-hypotheses", str(VOConfig(scale_mode="hold").ransac.n_hypotheses), "--seed", str(SEED)],
            capture_run=True)
        launches = read_launches()
        summary = docs[0]
        check_run_outputs(res, out_dir, n)
        if summary["config"] != json.loads(json.dumps(dataclasses.asdict(VOConfig(scale_mode="hold")))):
            raise AssertionError(f"the CLI's config is not phase 7's VOConfig(scale_mode='hold'): {summary['config']}")
        if launches != stream["launches"]:
            raise AssertionError(f"CLI launches {launches} differ from phase 7's {stream['launches']}")
        if int(checkpoint.load_state(ckpt)["next_start"]) != n:
            raise AssertionError("the CLI run did not stream to the end through its checkpoint")
        nm, nm7 = res.trajectory.n_matches, phase7.trajectory.n_matches
        if not np.array_equal(nm, nm7):
            raise AssertionError(f"CLI match counts differ from phase 7's on {int((nm != nm7).sum())} pairs")
        vo_diff = float(np.abs(res.trajectory.abs_poses - phase7.trajectory.abs_poses).max())
        _, est = tum.read_tum(os.path.join(out_dir, "stamped_traj_estimate_absolute.txt"))
        pose_diff = float(np.abs(est - phase7.vo_abs).max())
        ate_diff = abs(summary["ate_rmse_m"] - phase7.ate.rmse)
        log(f"cli.run_experiment on the converted sequence: {cli_s:.2f} s cold ({summary['frames_per_second']:.2f} "
            f"frames/s by its summary), launches {launches}; n_matches {n - 1}/{n - 1} pairs equal to phase 7's; "
            f"VO chain before the pose graph vs phase 7's {vo_diff:.3e} (its first pose is the converted marker "
            f"pose); TUM estimate after the pose graph vs phase 7's poses {pose_diff:.3e}, ATE "
            f"{summary['ate_rmse_m']!r} vs {phase7.ate.rmse!r} (tolerance {RESUME_POSE_TOL}); loop pairs "
            f"{res.backend_info['loop_pairs']}")
        if vo_diff > POSE_ROUND_TRIP_TOL:
            raise AssertionError(f"CLI VO chain {vo_diff} from phase 7's")
        if pose_diff > RESUME_POSE_TOL or ate_diff > RESUME_POSE_TOL:
            raise AssertionError(f"CLI poses {pose_diff} / ATE {ate_diff} from phase 7's")

        # The synthetic source with a profile, against an in-process run of the same sequence.
        prof_dir, synth_dir = os.path.join(tmp, "prof"), os.path.join(tmp, "synth")
        rendered = []
        real_render = synthetic.render_sequence
        synthetic.render_sequence = lambda cfg: rendered.append(real_render(cfg)) or rendered[-1]
        try:
            reset_launches()
            docs, synth_s, synth_res = run_cli(run_experiment.main, [
                "--synthetic", "--n-frames", str(SEQ_CONFIG["n_frames"]), "--width", str(SEQ_CONFIG["width"]),
                "--height", str(SEQ_CONFIG["height"]), "--backend", "none", "--seed", str(SEED),
                "--out-dir", synth_dir, "--profile-dir", prof_dir], capture_run=True)
            synth_launches = read_launches()
        finally:
            synthetic.render_sequence = real_render
        synth = docs[0]
        trace_mb = os.path.getsize(os.path.join(prof_dir, profiling.TRACE_FILE)) / 1e6
        ref = pipeline.run_experiment(rendered[0], config_from.vo_config_from_dict(synth["config"]), None, SEED,
                                      backend="none", device="cuda")
        synth_diff = abs(synth["ate_rmse_m"] - ref.ate.rmse)
        log(f"cli.run_experiment --synthetic {SEQ_CONFIG['n_frames']} frames at {SEQ_CONFIG['width']}x"
            f"{SEQ_CONFIG['height']} with --profile-dir: {synth_s:.2f} s, trace {trace_mb:.1f} MB, launches "
            f"{synth_launches}; ATE {synth['ate_rmse_m']!r} vs in-process {ref.ate.rmse!r} ({synth_diff:.3e})")
        if synth_diff > SYNTH_ATE_TOL or synth["median_matches"] != int(np.median(ref.trajectory.n_matches)):
            raise AssertionError("the synthetic CLI run differs from the in-process run")
        if synth_launches != {"fast_score": 4 * CAPTURE_TICKS, "orb_describe": 4 * CAPTURE_TICKS,
                              "hamming_match": CAPTURE_TICKS, "pose_graph_pcg": 0, "windowed_ba": 0,
                              "l2_match": 0}:
            raise AssertionError(f"synthetic CLI launches {synth_launches}")

        # analyze on both TUM directories. It scores every frame of the streams (as the reference's
        # does); the summary's ATE scores the marker-present frames. On the synthetic run the two
        # sets are one, so analyze gives the summary's ATE; on the bag run it gives the ATE of the
        # run's own poses over all frames.
        analyze_s, analyze_diff = {}, {}
        for label, d, run, want in (
            ("synthetic", synth_dir, synth_res, synth["ate_rmse_m"]),
            ("bag", out_dir, res, metrics.ate(np.linalg.inv(res.gt_abs), np.linalg.inv(res.vo_abs)).rmse),
        ):
            (report,), analyze_s[label], _ = run_cli(analyze.main, [d])
            analyze_diff[label] = abs(report["ate"]["rmse"] - want)
            tol = tum_ate_tolerance(tum, d, run)
            log(f"cli.analyze on the {label} run: {analyze_s[label]:.3f} s; ATE {report['ate']['rmse']!r} vs "
                f"{want!r} (difference {analyze_diff[label]:.3e}, tolerance {tol:.3e}: the TUM files' bound)")
            if analyze_diff[label] > tol:
                raise AssertionError(f"analyze's ATE on the {label} run {analyze_diff[label]} from {want}")

        # The debug images' shapes: a two-frame batch and the match at P = 1.
        pair = pipeline.preprocess_frames(head(rendered[0], 2), "cuda")
        fast_d, desc_d = frontend_levels(pair, VOConfig().n_keypoints, "dump pair")
        feats = detect_and_describe_batch(pair, k=VOConfig().n_keypoints)
        results["fast_score"]["dump_pair"] = frontend_row(fast_d)
        results["orb_describe"]["dump_pair"] = frontend_row(desc_d)
        results["hamming_match"]["dump_pair"] = match_case("dump pair", feats.desc[:1], feats.desc[1:],
                                                           feats.valid[:1], feats.valid[1:])
        try:
            import matplotlib  # noqa: F401  (absent on some card machines: --plot and --dump-matches need it)
        except ImportError:
            dump = "matplotlib absent: --plot and --dump-matches not run here (held by the CPU tests)"
        else:
            reset_launches()
            paths = pipeline.dump_match_images(rendered[0], VOConfig(), os.path.join(tmp, "debug"), n_pairs=2)
            dump = dict(images=len(paths), launches=read_launches())
            if dump["launches"] != {"fast_score": 8, "orb_describe": 8, "hamming_match": 2}:
                raise AssertionError(f"dump_match_images launches {dump['launches']}")
        log(f"dump_match_images: {dump}")
    return dict(bag_mb=bag_mb, bag_compression=compression, bag_write_s=bag_write_s, small_bags=small,
                convert_s=convert_s, convert_steps_s=walls, convert_frames_per_s=n / convert_s,
                bag_read_mb_per_s=bag_mb / walls["bag_read_decode"], stamp_err_s=stamp_err, pose_round_trip=pose_err,
                cli_s=cli_s, cli_frames_per_second=summary["frames_per_second"], cli_vo_diff=vo_diff,
                cli_pose_diff=pose_diff, cli_ate=summary["ate_rmse_m"], analyze_s=analyze_s,
                analyze_ate_diff=analyze_diff,
                synthetic_cli_s=synth_s, synthetic_ate_diff=synth_diff, trace_mb=trace_mb, launches=launches,
                synthetic_launches=synth_launches, dump_match_images=dump)


def phase_float(seq) -> dict:
    """Phase S, the SIFT and SURF frontends: on the bench workload, a warm
    run_sequence per mode (wall, frames/s, the device idle share under
    torch.profiler, launches: the float match's kernel, csrc/l2_match.cu,
    once a capture tick, and no kernel of the ORB path); on PARITY.md's clean scenario,
    run_experiment(backend="none") with the ATE and the per-pair ratio-match
    counts held to the JAX package's."""
    from droplet_visual_odometry_tpu_torch import parity, pipeline
    from droplet_visual_odometry_tpu_torch.data import synthetic
    from droplet_visual_odometry_tpu_torch.estimation.vo import run_sequence, run_sequence_eager

    frames = pipeline.make_preprocessor(seq, "cuda")(seq.frames)
    K = pipeline.effective_K(seq)
    corners = pipeline.effective_marker_corners(seq, K)
    clean = synthetic.render_sequence(synthetic.SyntheticConfig(**CLEAN_SEQ_CONFIG))
    out = {}
    for mode in FLOAT_MODES:
        cfg = parity.ours_config("marker", mode)
        args = (frames, corners, seq.marker_present, seq.marker_poses[0], K, seq.real_marker_length, cfg)
        reset_launches()
        traj = run_sequence(*args, seed=SEED)
        torch.cuda.synchronize()
        launches = read_launches()
        if launches != {**{k: 0 for k in launches}, "l2_match": CAPTURE_TICKS}:
            raise AssertionError(f"{mode}: expected the L2 match kernel alone, {CAPTURE_TICKS} ticks: {launches}")
        if not torch.isfinite(traj.abs_poses).all() or float(traj.ok.float().mean()) < 0.9:
            raise AssertionError(f"{mode}: non-finite poses or pairs ok {float(traj.ok.float().mean())}")
        warm = wall_ms(lambda: run_sequence(*args, seed=SEED), reps=3)
        eager = wall_ms(lambda: run_sequence_eager(*args, seed=SEED), reps=3)
        # torch.profiler traces graph replays incompletely: the device busy time is the eager twin's.
        prof, _ = device_profile(lambda: run_sequence_eager(*args, seed=SEED), runs=2, top=5)
        n = len(seq)
        log(f"{mode} run_sequence on the bench workload warm: {warm:.2f} ms as the captured graph = "
            f"{(n - 1) / warm * 1e3:.2f} frames/s; op by op {eager:.2f} ms, device busy "
            f"{prof['device_busy_ms_per_run']:.2f} ms a run, {prof['kernels_per_run']:.0f} kernels, idle "
            f"share {prof['device_idle_share']:.4f}; launches {launches}; n_matches {traj.n_matches.tolist()}")

        with tempfile.TemporaryDirectory() as out_dir:
            res = pipeline.run_experiment(clean, cfg, out_dir, SEED, backend="none", device="cuda")
            check_run_outputs(res, out_dir, len(clean))
        nm, want = res.trajectory.n_matches, np.asarray(JAX_FLOAT_N_MATCHES[mode])
        dev = float(np.abs(nm - want).sum() / want.sum())
        log(f"{mode} on the clean scenario: ATE rmse {res.ate.rmse!r} m (JAX package {JAX_FLOAT_ATE_RMSE[mode]} +- "
            f"{FLOAT_ATE_TOL[mode]}); match counts vs JAX {int((nm == want).sum())}/{len(want)} pairs equal, total "
            f"deviation {dev:.5f}; pairs ok {float(np.mean(res.trajectory.ok)):.4f}")
        if abs(res.ate.rmse - JAX_FLOAT_ATE_RMSE[mode]) > FLOAT_ATE_TOL[mode]:
            raise AssertionError(f"{mode} ATE {res.ate.rmse} outside {JAX_FLOAT_ATE_RMSE[mode]} +- {FLOAT_ATE_TOL[mode]}")
        if dev > MATCH_TOL:
            raise AssertionError(f"{mode} match counts deviate {dev:.4f} from the JAX package's")
        present = np.flatnonzero(clean.marker_present)
        out[mode] = dict(launches=launches, warm_ms=warm, eager_ms=eager, frames_per_s=(n - 1) / warm * 1e3,
                         clean_parity_row=parity.evaluate(clean, present, res.vo_abs[present]),
                         device_busy_ms=prof["device_busy_ms_per_run"], kernels_per_run=prof["kernels_per_run"],
                         device_idle_share=prof["device_idle_share"], clean_ate_rmse=res.ate.rmse,
                         clean_match_deviation=dev, clean_pairs_equal=int((nm == want).sum()))
    return out


def phase_parity(float_modes: dict, results) -> dict:
    """Phase P, the accuracy-parity harness (droplet_visual_odometry_tpu_torch/
    parity.py) on the card: parity.py's five scenarios at full size, the
    reference chain's three variants on the host and every "ours" row through
    run_experiment on the card; each port row held to its JAX row within
    twice the JAX seed spread, and parity.py's two gates against the
    reference rows of this run. The distorted_1440 default row runs first,
    with the launch counters (FAST and describe once per level on the frames
    and again on the keyframe stack, the match at least 3 times); phase S's
    clean-scenario SIFT/SURF runs are its rows there. Then the three kernels
    at drift_loop's shapes (200 frames of 640x480, the match at P = 199,
    K = 512) against their twins, timed beside their bounds."""
    import cv2

    from droplet_visual_odometry_tpu_torch import parity
    from droplet_visual_odometry_tpu_torch.frontend import features

    t_phase = time.perf_counter()
    scen = parity.scenarios(quick=False)
    render_s = time.perf_counter() - t_phase
    log(f"parity: rendered the five scenarios in {render_s:.1f} s")

    # The shipped default on the production lens, counted.
    dist = scen["distorted_1440"]
    reset_launches()
    pres, est = parity.run_ours(dist, backend="pose_graph", scale_mode="hold", seed=SEED, device="cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    n_levels = parity.ours_config().n_levels
    log(f"parity: distorted_1440 default row launches {launches}")
    want = (CAPTURE_TICKS + 1) * n_levels
    if launches["fast_score"] != want or launches["orb_describe"] != want:
        raise AssertionError(f"distorted_1440 default: expected {want} FAST and describe launches "
                             f"(the captured VO program and the keyframe stack), got {launches}")
    if launches["hamming_match"] < 2 * CAPTURE_TICKS + 1:
        raise AssertionError(f"distorted_1440 default: the match launched {launches['hamming_match']} times "
                             f"(< {2 * CAPTURE_TICKS + 1})")
    known = {
        "distorted_1440": {("pose_graph", "hold", "orb"): parity.evaluate(dist, pres, est)},
        "clean": {("none", "marker", m): float_modes[m]["clean_parity_row"] for m in FLOAT_MODES},
    }

    # The reference chain runs in worker processes while this one runs the port's rows.
    rows, walls = parity.run_all(scen, device="cuda", known=known)
    log("parity walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    for name, r in rows.items():
        log(f"parity {name}: " + ", ".join(f"{k} {v['ate_rmse_m']!r}" for k, v in r.items()))
    holds = parity.holds(rows)
    for name, hs in holds.items():
        for label, h in hs.items():
            log(f"parity hold {name} / {label}: port {h['port']!r} vs JAX {h['jax']!r} +- {h['tol']!r} "
                f"(margin {h['margin']!r}) {'ok' if h['ok'] else 'MISSED'}; JAX seeds {h['jax_range']} "
                f"{'inside' if h['in_range'] else 'OUTSIDE'}")
    outside = parity.outside_range(holds)
    for msg in outside:
        log(f"parity: {msg}")
    failures = parity.gate_failures(rows) + parity.hold_failures(rows)
    if sum(len(v) for v in holds.values()) != sum(len(parity.JAX_ATE_RMSE[n]) for n in scen):
        raise AssertionError("parity: a port row has no JAX row to hold it")
    if failures:
        raise AssertionError("parity: " + "; ".join(failures))

    # The kernels at drift_loop's shapes.
    frames = torch.as_tensor(scen["drift_loop"].frames).cuda().float()
    fast_r, desc_r = frontend_levels(frames, 512, "drift_loop")
    feats = features.detect_and_describe_batch(frames, k=512)
    match_r = match_case("drift_loop", feats.desc[:-1], feats.desc[1:], feats.valid[:-1], feats.valid[1:])
    results["fast_score"]["drift_loop"] = frontend_row(fast_r)
    results["orb_describe"]["drift_loop"] = dict(frontend_row(desc_r), angles_differ=desc_r["angles_differ"])
    results["hamming_match"]["drift_loop"] = match_r
    wall = time.perf_counter() - t_phase
    log(f"parity: phase P {wall:.1f} s; kernels at drift_loop's shapes: FAST {fast_r['ms']:.4f} ms "
        f"(bound {fast_r['bound_ms']:.4f}), describe {desc_r['ms']:.4f} ms (bound {desc_r['bound_ms']:.4f}), "
        f"match {match_r['ms']:.4f} ms (bound {match_r['bound_ms']:.4f})")
    return dict(rows=rows, holds=holds, outside_jax_range=outside, launches=launches, render_s=render_s,
                walls_s=walls, wall_s=wall,
                opencv=cv2.__version__, kernels_drift_loop=dict(
                    fast_score=frontend_row(fast_r), orb_describe=frontend_row(desc_r), hamming_match=match_r))


def online_engine(seq, cfg):
    from droplet_visual_odometry_tpu_torch import groundtruth, stream

    return stream.OnlineVO(np.asarray(seq.camera.K), seq.real_marker_length, cfg=cfg, seed=SEED,
                           gt_cfg=groundtruth.GroundTruthConfig(use_base_link=False), device="cuda")


def check_online_pushes(seq, cfg, label: str, n_push: int) -> tuple:
    """Arm an engine on frame 0, then push frames 1..n_push, each held bit
    for bit against the same step run op by op (step_eager: the same
    features and draws); returns (engine, the results of every push from
    the arming one on, the memory the first armed push added: static
    buffers and the graph's pool)."""
    from droplet_visual_odometry_tpu_torch.groundtruth import frame_detections

    vo = online_engine(seq, cfg)
    armed = vo.push(seq.timestamps[0], seq.frames[0], frame_detections(seq, 0))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    results = [armed]
    for i in range(1, n_push + 1):
        dets = frame_detections(seq, i)
        want = vo.step_eager(seq.frames[i], dets)
        r = vo.push(seq.timestamps[i], seq.frames[i], dets)
        if i == 1:  # the capture push; what stays reserved after empty_cache is the graph's pool and the buffers
            torch.cuda.empty_cache()
            mem = (torch.cuda.memory_allocated() - mem0[0], torch.cuda.memory_reserved() - mem0[1])
        got = np.concatenate([r.rel.reshape(16), [r.n_inliers, float(r.ok), r.n_matches]]).astype(np.float32)
        for name, sl in (("rel", slice(0, 16)), ("n_inliers", slice(16, 17)), ("ok", slice(17, 18)),
                         ("n_matches", slice(18, 19))):
            diff = np.abs(got[sl] - want.numpy()[sl])
            if diff.max() > 0:
                raise AssertionError(f"{label} push {i}: the graph's {name} differs from the eager step by "
                                     f"{diff.max()!r}")
        results.append(r)
    log(f"{label}: {n_push} graph-replayed pushes equal to the eager step bit for bit (rel, n_inliers, ok, "
        f"n_matches); launches in the graph {vo.captured_launches}")
    return vo, results, mem


def phase_online(seq, none_traj, kernels) -> dict:
    """Phase O, OnlineVO: SEQ_CONFIG's 24 frames pushed with their
    marker detections (ORB, VOConfig()), every graph replay held against
    the eager step bit for bit; match counts against run_sequence on the
    same frames, the chained pose against its chain with the same per-step
    draws; median push ms as a graph and eager, launches per push, the
    replay's device span by CUDA events and the eager step's device busy
    ms under torch.profiler, each push's idle share, the graph's memory;
    the three kernels at the push's shapes against their twins; then one
    SIFT engine's pushes against its eager step."""
    from droplet_visual_odometry_tpu_torch import parity
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig, run_sequence
    from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe
    from droplet_visual_odometry_tpu_torch.groundtruth import frame_detections
    from droplet_visual_odometry_tpu_torch.utils import threefry

    if not np.all(seq.marker_present):  # every push carries its frame's marker, as a live node's would
        raise AssertionError(f"frames {np.flatnonzero(~np.asarray(seq.marker_present)).tolist()} show no marker")
    cfg = VOConfig()
    n = len(seq)
    reset_launches()
    vo, results, mem = check_online_pushes(seq, cfg, "OnlineVO orb", n - 1)
    armed_pose, results = results[0].pose, results[1:]
    launches = dict(vo.captured_launches)
    n_levels = cfg.n_levels
    if launches != {"fast_score": n_levels, "orb_describe": n_levels, "hamming_match": 1, "pose_graph_pcg": 0,
                    "windowed_ba": 0, "l2_match": 0}:
        raise AssertionError(f"expected {n_levels}/{n_levels}/1/0 launches in the push graph, got {launches}")
    nm = np.asarray([r.n_matches for r in results])

    # run_sequence over the same raw frames with each push's draws: push `step` draws from
    # fold_in(PRNGKey(SEED), step), the pairs' keys here.
    steps = torch.arange(1, n, dtype=torch.int64, device="cuda")
    u_hyp, u_lo = threefry.ransac_uniforms(threefry.fold_in(threefry.prng_key(SEED, "cuda"), steps), cfg.ransac)
    frames = torch.as_tensor(seq.frames).cuda().float()
    traj = run_sequence(frames, seq.marker_corners, seq.marker_present, armed_pose, seq.camera.K,
                        seq.real_marker_length, cfg, u_hyp=u_hyp, u_lo=u_lo)
    nm_seq = traj.n_matches.cpu().numpy()
    pose_diff = float(np.abs(results[-1].pose - traj.abs_poses[-1].cpu().numpy()).max())
    log(f"OnlineVO n_matches {nm.tolist()}; run_sequence on the same frames: {int((nm == nm_seq).sum())}/{n - 1} "
        f"pairs equal; phase 4's run (undistorted frames): {int((nm == none_traj.n_matches).sum())}/{n - 1} equal; "
        f"final pose vs run_sequence's chain with the same draws: max abs difference {pose_diff:.3e} "
        f"(tolerance {ONLINE_POSE_TOL})")
    if not np.array_equal(nm, nm_seq):
        raise AssertionError(f"OnlineVO match counts differ from run_sequence's on {int((nm != nm_seq).sum())} pairs")
    if pose_diff > ONLINE_POSE_TOL:
        raise AssertionError(f"OnlineVO final pose {pose_diff} from run_sequence's chain")

    # Timing: a fresh engine, the capture push first, then warm pushes; eager steps on the same engine.
    # The replay's device span: CUDA events on the push's stream around graph.replay() (torch.profiler
    # traces graph replays incompletely). It counts the gaps between the graph's kernels as busy, so
    # 1 - span / wall is a lower bound on a push's idle share.
    vo = online_engine(seq, cfg)
    vo.push(seq.timestamps[0], seq.frames[0], frame_detections(seq, 0))
    vo.push(seq.timestamps[1], seq.frames[1], frame_detections(seq, 1))
    order = [2 + i % (n - 2) for i in range(ONLINE_TIMED)]
    dets = {i: frame_detections(seq, i) for i in set(order)}
    graph, events = vo._graph, []

    def timed_replay():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))

    vo._graph = types.SimpleNamespace(replay=timed_replay)
    push_ms, eager_ms = [], []
    for i in order:
        t0 = time.perf_counter()
        vo.push(seq.timestamps[i], seq.frames[i], dets[i])
        push_ms.append((time.perf_counter() - t0) * 1e3)
    vo._graph = graph
    torch.cuda.synchronize()
    span_ms = [start.elapsed_time(end) for start, end in events]
    for i in order:
        t0 = time.perf_counter()
        vo.step_eager(seq.frames[i], dets[i])
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    it = iter(order * 2)

    def one_eager():
        i = next(it)
        vo.step_eager(seq.frames[i], dets[i])

    prof_eager, _ = device_profile(one_eager, runs=10, top=8)
    idle = {"graph": 1.0 - float(np.median(span_ms)) / float(np.median(push_ms)),
            "eager": 1.0 - prof_eager["device_busy_ms_per_run"] / float(np.median(eager_ms))}
    log(f"OnlineVO push at 1440x1080: graph {np.median(push_ms):.3f} ms median of {len(push_ms)} (min "
        f"{min(push_ms):.3f}), eager step {np.median(eager_ms):.3f} ms median (min {min(eager_ms):.3f}); the "
        f"replay's device span by CUDA events {np.median(span_ms):.3f} ms median (min {min(span_ms):.3f}, max "
        f"{max(span_ms):.3f}); the eager step's device busy under torch.profiler "
        f"{prof_eager['device_busy_ms_per_run']:.3f} ms, {prof_eager['kernels_per_run']:.0f} kernels; idle share "
        f"of a push: graph at least {idle['graph']:.4f} (span against the wall), eager {idle['eager']:.4f}; the "
        f"capture push left {mem[0] / 1e6:.1f} MB allocated and {mem[1] / 1e6:.1f} MB reserved after empty_cache "
        f"(static buffers and the graph's pool)")

    # The kernels at the push's shapes against their twins: FAST and describe on the next frame's
    # levels, the match (P = 1) of the features the engine carries against that frame's.
    i_next = 2 + ONLINE_TIMED % (n - 2)
    fast_o, desc_o = frontend_levels(frames[i_next:i_next + 1], cfg.n_keypoints, "online push")
    curr = detect_and_describe(frames[i_next], k=cfg.n_keypoints, threshold=cfg.fast_threshold,
                               arc_length=cfg.fast_arc_length)
    prev = vo._static["prev"]
    kernels["fast_score"]["online_push"] = frontend_row(fast_o)
    kernels["orb_describe"]["online_push"] = frontend_row(desc_o)
    kernels["hamming_match"]["online_push"] = match_case("online push", prev.desc[None], curr.desc[None],
                                                         prev.valid[None], curr.valid[None])

    # One SIFT engine: capture and replay against its eager step.
    check_online_pushes(seq, parity.ours_config("marker", "sift"), "OnlineVO sift", 3)
    return dict(launches_per_push=launches, push_ms=float(np.median(push_ms)), eager_ms=float(np.median(eager_ms)),
                push_ms_all=push_ms, eager_ms_all=eager_ms, replay_span_ms=float(np.median(span_ms)),
                replay_span_ms_all=span_ms, profile_eager=prof_eager, idle_share=idle,
                graph_mb_allocated=mem[0] / 1e6, graph_mb_reserved=mem[1] / 1e6, final_pose_diff=pose_diff,
                n_matches=nm.tolist())


def mesh_inputs(seq):
    """Phase M's pair-VO inputs: frames 0-MESH_PAIRS of the loop, undistorted
    on the current card, and the args of (shard_)pair_vo_batched with
    VOConfig()."""
    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig

    n = MESH_PAIRS + 1
    frames = pipeline.make_preprocessor(seq, "cuda")(seq.frames[:n])
    K = pipeline.effective_K(seq).astype(np.float32)
    corners = np.nan_to_num(pipeline.effective_marker_corners(seq, K)[:n]).astype(np.float32)
    present = np.asarray(seq.marker_present[:n])
    args = (frames[:-1], frames[1:], corners[:-1], corners[1:], present[:-1] & present[1:], K,
            seq.real_marker_length, VOConfig())
    return frames, corners, present, args


def recorded_ba_windows(ba: dict, cfg=None) -> list:
    """Phase 6's real BA windows: refine_trajectory rerun on its inputs (with
    RefineConfig cfg in place of its own, where given) with run_ba wrapped
    to record every window it solves, with its config."""
    from droplet_visual_odometry_tpu_torch.backend import refine

    d, windows, run_ba = ba["inputs"], [], refine.ba.run_ba
    args = d["args"] if cfg is None else (*d["args"][:-1], cfg)

    def record(window, cfg):
        windows.append((window, cfg))
        return run_ba(window, cfg)

    refine.ba.run_ba = record
    try:
        refine.refine_trajectory(*args, **d["kw"])
    finally:
        refine.ba.run_ba = run_ba
    return windows


def allreduce_ms(rows: int, device) -> float:
    """Mean host wall (synchronised) of one all_reduce of a (rows, 6) f32
    tensor on the card over the current default group: the PCG's collective."""
    import torch.distributed as dist

    t = torch.zeros((rows, 6), device=device)
    for _ in range(5):
        dist.all_reduce(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MESH_ALLREDUCE_REPS):
        dist.all_reduce(t)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / MESH_ALLREDUCE_REPS * 1e3


def mesh_world_one(loop_seq, pg: dict, ba: dict, kernels: dict) -> dict:
    """M1, a world of one rank over NCCL on cuda:0 (the process group is up):
    shard_pair_vo on MESH_PAIRS pairs of the loop with VOConfig() and seeded
    draws, captured with its all_gather (launches CAPTURE_TICKS x 4/4/1,
    4/4/1 a replay), against pair_vo_batched and run_sequence on the same
    frames and draws (bit for bit); the kernels at the path's shapes against
    their twins; the edge-sharded optimize on phase 5's graph and
    run_ba_distributed on phase 6's windows against their one-device forms;
    each sharded program as a row of phase G's kind (program_row: capture,
    replay, device span, graph memory, its eager twin; the pair VO and BA
    bit for bit, optimize within MESH_PCG_TOL); warm walls of the captured
    forms beside the eager ones, and the NCCL all_reduce latency. Also the
    references M2 is held to: each rank's half batch through
    pair_vo_batched, and each BA window's own sensitivity to the order of
    its landmark sums (run_ba with the landmarks reversed)."""
    import torch.distributed as dist

    from droplet_visual_odometry_tpu_torch.backend import ba as ba_mod
    from droplet_visual_odometry_tpu_torch.backend import pose_graph
    from droplet_visual_odometry_tpu_torch.estimation.vo import run_sequence
    from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch
    from droplet_visual_odometry_tpu_torch.parallel import distributed_ba, launch, sharding
    from droplet_visual_odometry_tpu_torch.utils import graphs, threefry

    mesh = launch.global_mesh()
    if (dist.get_backend(), mesh.size, mesh.rank, mesh.backend) != ("nccl", 1, 0, "nccl"):
        raise AssertionError(f"M1 wants a one-rank NCCL world, got {dist.get_backend()} {mesh}")
    frames, corners, present, args = mesh_inputs(loop_seq)
    cfg = args[-1]
    u_hyp, u_lo = sharding.ransac_draws(MESH_PAIRS, cfg, threefry.prng_key(SEED, mesh.device))
    draws = dict(u_hyp=u_hyp, u_lo=u_lo)
    reset_launches()
    rels = sharding.shard_pair_vo(mesh, *args, **draws)
    torch.cuda.synchronize()
    launches = read_launches()
    progs = [p for p in graphs.programs() if p.name == "shard_pair_vo"]
    log(f"M1 shard_pair_vo over {MESH_PAIRS} pairs of 1440x1080 (NCCL, world 1): kernel launches {launches}, "
        f"captured {[p.captured_launches for p in progs]}")
    per_replay = {"fast_score": cfg.n_levels, "orb_describe": cfg.n_levels, "hamming_match": 1, "pose_graph_pcg": 0,
                  "windowed_ba": 0, "l2_match": 0}
    if launches != {k: CAPTURE_TICKS * v for k, v in per_replay.items()}:
        raise AssertionError(f"expected {CAPTURE_TICKS} x {per_replay} launches (one capture of the 2B frames' "
                             f"program), got {launches}")
    if len(progs) != 1 or progs[0].captured_launches != per_replay or progs[0].mesh is not mesh:
        raise AssertionError(f"shard_pair_vo was not captured once over the mesh with {per_replay} a replay")
    if rels.shape != (MESH_PAIRS, 4, 4) or not bool(torch.isfinite(rels).all()):
        raise AssertionError(f"shard_pair_vo rels {tuple(rels.shape)}, finite {bool(torch.isfinite(rels).all())}")
    plain = sharding.pair_vo_batched(*args, **draws)
    traj = run_sequence(frames, corners, present, loop_seq.marker_poses[0], args[5], args[6], cfg, **draws)
    if not (torch.equal(rels, plain) and torch.equal(rels, traj.rel_poses)):
        raise AssertionError(f"shard_pair_vo differs from pair_vo_batched by {float((rels - plain).abs().max())}, "
                             f"from run_sequence by {float((rels - traj.rel_poses).abs().max())}")
    # Each rank of M2 runs half the pairs: the same pairs through pair_vo_batched at that batch size.
    h = MESH_PAIRS // 2
    halves = torch.cat([sharding.pair_vo_batched(*(a[sl] for a in args[:5]), *args[5:], u_hyp=u_hyp[sl],
                                                 u_lo=u_lo[sl]) for sl in (slice(0, h), slice(h, None))])
    half_diff = float((halves - rels).abs().max())
    log(f"M1 rels equal to pair_vo_batched's and to run_sequence's on the same {MESH_PAIRS + 1} frames and draws, "
        f"bit for bit; the same pairs in two batches of {h}: max abs difference {half_diff!r} from one batch of "
        f"{MESH_PAIRS} (the card's arithmetic depends on the batch size)")

    # The kernels at the path's shapes: FAST and describe on the 2B frames, the match at P = B.
    fast_m, desc_m = frontend_levels(torch.cat([args[0], args[1]]), cfg.n_keypoints, "mesh pairs")
    feats = detect_and_describe_batch(torch.cat([args[0], args[1]]), k=cfg.n_keypoints)
    b = MESH_PAIRS
    kernels["fast_score"]["mesh_pairs"] = frontend_row(fast_m)
    kernels["orb_describe"]["mesh_pairs"] = frontend_row(desc_m)
    kernels["hamming_match"]["mesh_pairs"] = match_case("mesh pairs", feats.desc[:b], feats.desc[b:],
                                                        feats.valid[:b], feats.valid[b:])

    graph, pg_cfg = pg["graph"], pg["inputs"]["cfg"].pg
    single = pose_graph.optimize(graph, pg_cfg)
    sharded = pose_graph.optimize(graph, pg_cfg, mesh=mesh)
    pcg_diff = float((sharded.poses - single.poses).abs().max())
    if pcg_diff > MESH_PCG_TOL or not float(sharded.final_cost) < float(sharded.initial_cost):
        raise AssertionError(f"edge-sharded optimize {pcg_diff} from the plain one, cost {float(sharded.final_cost)}")

    windows = recorded_ba_windows(ba)
    if not windows:
        raise AssertionError("phase 6's run solved no BA window")
    ba_rows, ba_single = [], []
    for i, (window, wcfg) in enumerate(windows):
        one, dres = ba_mod.run_ba(window, wcfg), distributed_ba.run_ba_distributed(mesh, window, wcfg)
        rv = torch.arange(window.points.shape[0] - 1, -1, -1, device=window.points.device)
        flipped = ba_mod.run_ba(ba_mod.BAWindow(window.poses, window.points[rv], window.obs_uv[:, rv],
                                                window.obs_mask[:, rv], window.K), wcfg)
        ba_single.append(one)
        pose_d = float((dres.poses - one.poses).abs().max())
        point_d = float((dres.points[: window.points.shape[0]] - one.points).abs().max())
        if pose_d > MESH_BA_POSE_TOL or point_d > MESH_BA_POINT_TOL:
            raise AssertionError(f"run_ba_distributed window {i}: poses {pose_d}, points {point_d} from run_ba")
        ba_rows.append(dict(landmarks=int(window.points.shape[0]), pose_diff=pose_d, point_diff=point_d,
                            reversed_landmarks_pose_diff=float((flipped.poses - one.poses).abs().max()),
                            ms=wall_ms(lambda: distributed_ba.run_ba_distributed(mesh, window, wcfg), reps=3),
                            eager_ms=wall_ms(lambda: distributed_ba.run_ba_distributed_eager(mesh, window, wcfg),
                                             reps=3),
                            run_ba_ms=wall_ms(lambda: ba_mod.run_ba(window, wcfg), reps=3)))
    times = dict(
        shard_pair_vo_ms=wall_ms(lambda: sharding.shard_pair_vo(mesh, *args, **draws), reps=3),
        shard_pair_vo_eager_ms=wall_ms(lambda: sharding.shard_pair_vo_eager(mesh, *args, **draws), reps=3),
        pair_vo_batched_ms=wall_ms(lambda: sharding.pair_vo_batched(*args, **draws), reps=3),
        pair_vo_batched_eager_ms=wall_ms(lambda: sharding.pair_vo_batched_eager(*args, **draws), reps=3),
        optimize_mesh_ms=wall_ms(lambda: pose_graph.optimize(graph, pg_cfg, mesh=mesh), reps=3),
        optimize_mesh_eager_ms=wall_ms(lambda: pose_graph.optimize_eager(graph, pg_cfg, mesh=mesh), reps=3),
        optimize_ms=wall_ms(lambda: pose_graph.optimize(graph, pg_cfg), reps=3),
        nccl_allreduce_ms=allreduce_ms(int(graph.poses.shape[0]), mesh.device),
    )
    log(f"M1 edge-sharded optimize on phase 5's graph ({tuple(graph.poses.shape)[0]} nodes, "
        f"{graph.edge_i.shape[0]} edges): poses {pcg_diff:.3e} from the plain optimize (tolerance {MESH_PCG_TOL}); "
        f"run_ba_distributed on phase 6's {len(windows)} windows: poses {max(r['pose_diff'] for r in ba_rows):.3e}, points "
        f"{max(r['point_diff'] for r in ba_rows):.3e} from run_ba (tolerances {MESH_BA_POSE_TOL} / "
        f"{MESH_BA_POINT_TOL}); warm walls {json.dumps(times)}; BA per window {json.dumps(ba_rows)}")
    return dict(launches=launches, halves=halves, pcg_poses=single.poses, ba_single=ba_single, windows=windows,
                graph=graph, pg_cfg=pg_cfg, draws=draws,
                checks=dict(rels_equal_pair_vo_batched_and_run_sequence=True, rels_two_batches_vs_one=half_diff,
                            pcg_pose_diff=pcg_diff, ba=ba_rows),
                times=times, programs=mesh_program_rows(mesh, args, draws, graph, pg_cfg, windows))


def mesh_program_rows(mesh, args, draws, graph, pg_cfg, windows) -> dict:
    """M1's sharded programs, each captured afresh and held against its eager
    twin as phase G holds the one-device programs (program_row): the pair
    VO with and without the mesh, optimize over the mesh (one GN step a
    replay) and run_ba_distributed on each (W, L) signature of phase 6's
    windows."""
    from droplet_visual_odometry_tpu_torch.backend import pose_graph
    from droplet_visual_odometry_tpu_torch.parallel import distributed_ba, sharding
    from droplet_visual_odometry_tpu_torch.utils import graphs

    graphs.clear()
    rows = {
        "shard_pair_vo": program_row(
            f"shard_pair_vo over the one-rank NCCL mesh ({MESH_PAIRS} pairs, its all_gather inside)",
            lambda: sharding.shard_pair_vo(mesh, *args, **draws),
            lambda: sharding.shard_pair_vo_eager(mesh, *args, **draws), equal_fields),
        "pair_vo_batched": program_row(
            f"pair_vo_batched, one device ({MESH_PAIRS} pairs)", lambda: sharding.pair_vo_batched(*args, **draws),
            lambda: sharding.pair_vo_batched_eager(*args, **draws), equal_fields),
        "optimize_mesh": program_row(
            f"pose_graph.optimize over the mesh, one GN step a replay ({tuple(graph.poses.shape)[0]} nodes, "
            f"{graph.edge_i.shape[0]} edges, a broadcast and {pg_cfg.cg_iters} all_reduces inside)",
            lambda: pose_graph.optimize(graph, pg_cfg, mesh=mesh),
            lambda: pose_graph.optimize_eager(graph, pg_cfg, mesh=mesh), within(MESH_PCG_TOL, "poses", "final_cost")),
    }
    sigs = {}
    for w, c in windows:
        sigs.setdefault((tuple(w.poses.shape), tuple(w.points.shape)), (w, c))
    rows["run_ba_distributed"] = [dict(window=f"W = {ws[0]}, L = {ls[0]}", row=program_row(
        f"run_ba_distributed over the mesh (W = {ws[0]}, L = {ls[0]}, {c.iters} LM steps, their psums inside)",
        lambda: distributed_ba.run_ba_distributed(mesh, w, c),
        lambda: distributed_ba.run_ba_distributed_eager(mesh, w, c), equal_fields))
        for (ws, ls), (w, c) in sigs.items()]
    return rows


def mesh_rank(rank: int, tmp: str) -> None:
    """M2's rank (a spawned process): two ranks share cuda:0 over gloo on CUDA
    tensors. Repeats M1's three calls on the inputs M1 saved, times the gloo
    all_reduce, runs run_experiment(backend="pose_graph") on the loop (its
    PCG sharded over both ranks by mesh="auto") and saves its results."""
    import torch.distributed as dist

    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.backend import pose_graph
    from droplet_visual_odometry_tpu_torch.data import sequence
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu_torch.parallel import distributed_ba, launch, sharding

    launch.initialize(f"file://{os.path.join(tmp, 'store')}", 2, rank, device="cuda:0", backend="gloo")
    try:
        inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        seq = sequence.load(os.path.join(tmp, "loop.npz"))
        mesh = launch.global_mesh(device="cuda:0")
        out = {"mesh": [mesh.size, mesh.rank, str(mesh.device), dist.get_backend()]}
        cuda = lambda ts: type(ts)(*(t.to(mesh.device) for t in ts))
        _, _, _, args = mesh_inputs(seq)
        draws = {k: v.to(mesh.device) for k, v in inp["draws"].items()}
        out["rels"] = sharding.shard_pair_vo(mesh, *args, **draws).cpu()
        res = pose_graph.optimize(cuda(inp["graph"]), inp["pg_cfg"], mesh=mesh)
        out["pcg"] = dict(poses=res.poses.cpu(), final_cost=float(res.final_cost))
        out["ba"] = []
        for w, c in inp["windows"]:
            r = distributed_ba.run_ba_distributed(mesh, cuda(w), c)
            out["ba"].append(dict(poses=r.poses.cpu(), final_cost=float(r.final_cost)))
        out["gloo_allreduce_ms"] = allreduce_ms(int(inp["graph"].poses.shape[0]), mesh.device)
        with tempfile.TemporaryDirectory() as out_dir:
            t0 = time.perf_counter()
            res = pipeline.run_experiment(seq, VOConfig(scale_mode="hold"), out_dir, SEED, backend="pose_graph",
                                          device="cuda:0")
            torch.cuda.synchronize()
            out["run_experiment"] = dict(wall_s=time.perf_counter() - t0, info=res.backend_info, vo_abs=res.vo_abs,
                                         vo_chain=np.asarray(res.trajectory.abs_poses), ate_rmse=res.ate.rmse)
        torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
    finally:
        launch.shutdown()


def mesh_two_ranks(loop_seq, pg: dict, m1: dict) -> dict:
    """M2: spawn two ranks on cuda:0 over gloo (mesh_rank), each within
    MESH_CHILD_TIMEOUT_S, and hold them to M1: the rels to each rank's half
    batch bit for bit, the PCG poses to the one-device optimize within
    MESH_PCG_TOL, each BA window's poses within MESH_BA_POSE_TOL or twice its
    own landmark-order sensitivity and its cost within MESH_BA_COST_RTOL;
    run_experiment with pg_mesh_devices 2, phase 5's VO chain bit for bit
    and loop pairs, and poses within RESUME_POSE_TOL of phase 5's backend
    on that chain; both ranks' replicated results equal bit for bit."""
    import multiprocessing

    from droplet_visual_odometry_tpu_torch.backend import refine
    from droplet_visual_odometry_tpu_torch.data import sequence
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig

    cpu = lambda ts: type(ts)(*(t.cpu() for t in ts))
    with tempfile.TemporaryDirectory() as tmp:
        sequence.save(os.path.join(tmp, "loop.npz"), loop_seq)
        torch.save(dict(draws={k: v.cpu() for k, v in m1["draws"].items()}, graph=cpu(m1["graph"]),
                        pg_cfg=m1["pg_cfg"], windows=[(cpu(w), c) for w, c in m1["windows"]]),
                   os.path.join(tmp, "inputs.pt"))
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=mesh_rank, args=(r, tmp)) for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout=max(1.0, MESH_CHILD_TIMEOUT_S - (time.perf_counter() - t0)))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise AssertionError(f"M2 ranks exited {codes} (a timeout after {MESH_CHILD_TIMEOUT_S} s is a kill)")
        wall_s = time.perf_counter() - t0
        outs = [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False) for r in range(2)]

    # Phase 5's backend on phase 5's VO chain, on one device: what M2's run is held to.
    d = pg["inputs"]
    ref, _ = refine.pose_graph_trajectory(d["frames"], d["vo_abs"], d["traj"].n_inliers, d["corners"],
                                          loop_seq.marker_present, d["K"], d["L"], VOConfig(scale_mode="hold"),
                                          d["cfg"], pair_scale_ok=d["traj"].scale_ok)
    ba_tol = [max(MESH_BA_POSE_TOL, 2 * r["reversed_landmarks_pose_diff"]) for r in m1["checks"]["ba"]]
    rows = []
    for r, o in enumerate(outs):
        run = o["run_experiment"]
        row = dict(
            mesh=o["mesh"],
            rels_vs_halves=float((o["rels"] - m1["halves"].cpu()).abs().max()),
            pcg_vs_m1=float((o["pcg"]["poses"] - m1["pcg_poses"].cpu()).abs().max()),
            ba_pose_diff=[float((b["poses"] - s.poses.cpu()).abs().max()) for b, s in zip(o["ba"], m1["ba_single"])],
            ba_cost_rdiff=[abs(b["final_cost"] - float(s.final_cost)) / float(s.final_cost)
                           for b, s in zip(o["ba"], m1["ba_single"])],
            gloo_allreduce_ms=o["gloo_allreduce_ms"],
            pg_mesh_devices=run["info"]["pg_mesh_devices"],
            loop_pairs_equal=run["info"]["loop_pairs"] == pg["info"]["loop_pairs"],
            vo_chain_vs_phase5=float(np.abs(run["vo_chain"] - np.asarray(d["traj"].abs_poses)).max()),
            poses_vs_phase5=float(np.abs(run["vo_abs"] - ref).max()),
            ate_rmse=run["ate_rmse"], run_experiment_s=run["wall_s"],
        )
        rows.append(row)
        log(f"M2 rank {r}: {json.dumps(row)}")
        if row["mesh"] != [2, r, "cuda:0", "gloo"]:
            raise AssertionError(f"M2 rank {r} mesh {row['mesh']}")
        if row["rels_vs_halves"] != 0.0 or row["pcg_vs_m1"] > MESH_PCG_TOL:
            raise AssertionError(f"M2 rank {r} disagrees with M1: {row}")
        if any(d_ > t for d_, t in zip(row["ba_pose_diff"], ba_tol)) or max(row["ba_cost_rdiff"]) > MESH_BA_COST_RTOL:
            raise AssertionError(f"M2 rank {r} BA against run_ba: {row['ba_pose_diff']} (tolerances {ba_tol}), "
                                 f"costs {row['ba_cost_rdiff']}")
        if row["pg_mesh_devices"] != 2 or not row["loop_pairs_equal"] or row["vo_chain_vs_phase5"] != 0.0:
            raise AssertionError(f"M2 rank {r} run_experiment: {row}; loop pairs {run['info']['loop_pairs']} vs "
                                 f"phase 5's {pg['info']['loop_pairs']}")
        if row["poses_vs_phase5"] > RESUME_POSE_TOL:
            raise AssertionError(f"M2 rank {r} refined poses {row['poses_vs_phase5']} from phase 5's backend")
    same = (torch.equal(outs[0]["pcg"]["poses"], outs[1]["pcg"]["poses"])
            and all(torch.equal(a["poses"], b["poses"]) for a, b in zip(outs[0]["ba"], outs[1]["ba"]))
            and np.array_equal(outs[0]["run_experiment"]["vo_abs"], outs[1]["run_experiment"]["vo_abs"]))
    log(f"M2 ranks hold the same replicated results bit for bit: {same}")
    if not same:
        raise AssertionError("M2's two ranks disagree on replicated results")
    return dict(ranks=rows, ranks_equal=same, ba_pose_tolerances=ba_tol, wall_s=wall_s)


def mesh_scaling() -> dict:
    """M3: cli.scaling --spawn 2 --ba --total-devices 2 at 1440x1080 on the
    card: a 1-rank and a 2-rank gloo run over the same workload. On one card
    the ratio is the cost of the process boundary, not scaling across cards."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "droplet_visual_odometry_tpu_torch.cli.scaling", "--spawn", "2", "--ba",
           "--total-devices", "2", "--height", "1080", "--width", "1440"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([here] + ([os.environ["PYTHONPATH"]]
                                                                 if os.environ.get("PYTHONPATH") else [])))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=here, env=env, timeout=MESH_SCALING_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"cli.scaling --spawn 2 exited {proc.returncode}: {proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    if set(report["workloads"]) != {"pair_vo", "distributed_ba"}:
        raise AssertionError(f"cli.scaling report has workloads {sorted(report['workloads'])}")
    report["label"] = ("2 ranks sharing one card over gloo against 1 rank: the cost of the process boundary, "
                      "not scaling across cards")
    report["wall_s"] = time.perf_counter() - t0
    return report


def phase_mesh(loop_seq, pg: dict, ba: dict, kernels: dict) -> dict:
    """Phase M, the multi-device layer on one card: M1 (a world of one rank
    over NCCL), M2 (two ranks sharing cuda:0 over gloo) and M3
    (cli.scaling --spawn 2). Each process group is destroyed at its end."""
    import socket

    import torch.distributed as dist

    from droplet_visual_odometry_tpu_torch.parallel import launch
    from droplet_visual_odometry_tpu_torch.utils import graphs

    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if not launch.initialize(f"127.0.0.1:{port}", 1, 0):
        raise AssertionError("launch.initialize brought up no process group")
    try:
        m1 = mesh_world_one(loop_seq, pg, ba, kernels)
    finally:
        # The mesh's captured programs hold its communicator: drop them before the group goes.
        graphs.clear(mesh=launch.global_mesh())
        left = [p.name for p in graphs.programs() if p.mesh is not None]
        launch.shutdown()
    if left or dist.is_initialized():
        raise AssertionError(f"M1 teardown left programs {left} over the mesh, group up {dist.is_initialized()}")
    m2 = mesh_two_ranks(loop_seq, pg, m1)
    log(f"M2 gloo all_reduce of ({int(m1['graph'].poses.shape[0])}, 6) f32 on CUDA tensors "
        f"{[r['gloo_allreduce_ms'] for r in m2['ranks']]} ms against NCCL's {m1['times']['nccl_allreduce_ms']:.4f} ms (M1)")
    m3 = mesh_scaling()
    log(json.dumps({"scaling": m3}))
    return dict(launches=m1["launches"], m1=dict(checks=m1["checks"], times=m1["times"], programs=m1["programs"]),
                m2=m2,
                m3_cross_process_efficiency={k: v["cross_process_efficiency"] for k, v in m3["workloads"].items()},
                wall_s=time.perf_counter() - t0)


def device_profile(call, runs: int, top: int) -> tuple[dict, list]:
    """torch.profiler over `runs` warm calls: host ms per run, CUDA kernels
    per run, device busy ms per run, device idle share and the top kernels
    by device time; and the profiler's events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runs):
            call()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    if busy_us <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return dict(
        profiled_ms_per_run=window_s * 1e3 / runs,
        kernels_per_run=sum(e.count for e in dev) / runs,
        device_busy_ms_per_run=busy_us / 1e3 / runs,
        device_idle_share=1.0 - busy_us / 1e6 / window_s,
        top_kernels_ms_per_run=[
            [e.key[:80], e.count // runs, e.self_device_time_total / 1e3 / runs]
            for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]
        ],
    ), events


def top_aten_ops(events, runs: int, top: int = 12) -> list:
    return [[e.key, e.count // runs]
            for e in sorted((e for e in events if e.key.startswith("aten::")), key=lambda e: -e.count)[:top]]


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
    from droplet_visual_odometry_tpu_torch import pipeline
    from droplet_visual_odometry_tpu_torch.estimation import scale as scale_mod
    from droplet_visual_odometry_tpu_torch.estimation.ransac import ransac_pose
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig, chain_poses, run_sequence, run_sequence_eager
    from droplet_visual_odometry_tpu_torch.frontend import matcher
    from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch
    from droplet_visual_odometry_tpu_torch.frontend.orb import Features
    from droplet_visual_odometry_tpu_torch.utils import threefry

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
    keys = threefry.split(threefry.prng_key(SEED, "cuda"), len(seq) - 1)
    R, t, _ = ransac_pose(p1, p2, valid, Kt, cfg.ransac, keys=keys)
    rels = torch.eye(4, device="cuda").repeat(len(seq) - 1, 1, 1)
    stages = {
        "frontend": lambda: detect_and_describe_batch(frames, k=cfg.n_keypoints),
        "match": lambda: matcher.match(fp.desc, fc.desc, fp.valid, fc.valid),
        "ransac_pose": lambda: ransac_pose(p1, p2, valid, Kt, cfg.ransac, keys=keys),
        "scale": lambda: scale_mod.scale_factor_with_valid(
            Kt, R, t, ct[:-1], ct[1:], seq.real_marker_length, present[:-1] & present[1:]),
        "chain": lambda: chain_poses(torch.eye(4, device="cuda"), rels),
    }
    out = {"stage_ms": {name: wall_ms(fn) for name, fn in stages.items()}}
    out["run_sequence_ms"] = wall_ms(lambda: run_sequence(*args, seed=SEED))
    out["run_sequence_eager_ms"] = wall_ms(lambda: run_sequence_eager(*args, seed=SEED))

    # torch.profiler traces graph replays incompletely: the profile is of the eager twin.
    prof, events = device_profile(lambda: run_sequence_eager(*args, seed=SEED), runs=3, top=12)
    out.update(prof, top_aten_ops_per_run=top_aten_ops(events, runs=3))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one GPU.")
    parser.add_argument("--profile", action="store_true", help="also run the stage breakdown and torch.profiler")
    opts = parser.parse_args()
    t0 = time.perf_counter()
    kind = phase_environment()
    seq = phase_data()
    log(json.dumps({"draws": phase_draws()}))
    kernels = phase_kernels(seq)
    launches_none, none_traj = phase_end_to_end(seq)
    loop_seq = phase_loop_data()
    pg = phase_pose_graph(loop_seq, kernels)
    ba = phase_ba(loop_seq, kernels)
    stream_seq = stream_sequence()
    stream = phase_stream(stream_seq, kernels)
    log(json.dumps({"stream": {k: v for k, v in stream.items() if k not in ("launches", "info", "result")}}))
    log(json.dumps({"graphs": phase_graphs(seq, loop_seq, pg, ba, stream_seq)}))
    ingest = phase_ingest(stream_seq, stream, kernels)
    del stream_seq
    log(json.dumps({"ingest": ingest}))
    float_modes = phase_float(seq)
    log(json.dumps({"float_frontends": float_modes}))
    par = phase_parity(float_modes, kernels)
    log(json.dumps({"parity": par}))
    online = phase_online(seq, none_traj, kernels)
    log(json.dumps({"online": online}))
    mesh = phase_mesh(loop_seq, pg, ba, kernels)
    log(json.dumps({"mesh": mesh}))
    if opts.profile:
        prof = phase_profile(seq)
        prof["pose_graph"] = profile_pose_graph(loop_seq, pg)
        prof["ba"] = profile_ba(ba)
        log(json.dumps({"profile": prof}))
    # `launches` counts the streamed run of the shipped default (run_experiment(backend="pose_graph") over
    # 400 frames at 1440x1080: VO chunk by chunk, then the keyframe stack, retrieval and verification);
    # launches_by_path gives each path's own run, the counts set to 0 just before it.
    # "online" is per push: the launches captured in the push's graph, which every replay runs.
    by_path = {"none": launches_none, "pose_graph": pg["launches"], "ba": ba["launches"], "stream": stream["launches"],
               "cli": ingest["launches"], "online": online["launches_per_push"], "mesh": mesh["launches"],
               "parity": par["launches"],
               **{m: float_modes[m]["launches"] for m in FLOAT_MODES}}
    rows = [
        dict(r, name=name, route="cuda", replaces=REPLACES[name], launches=stream["launches"][name],
             launches_by_path={path: counts[name] for path, counts in by_path.items()}, library_ms=None)
        for name, r in kernels.items()
    ]
    log(f"chip_smoke: all phases {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
