"""ops/cuda_ba on the CPU: the windowed BA kernel's routing, its plan and the `ba_kernel` count.

csrc/windowed_ba.cu runs only on the card, where
tests/test_torch_cuda_kernels.py holds it against run_ba_eager. Here a CPU
window goes to its plain twin, `fits` decides by shape and dtype alone, and
refine_trajectory's `ba.solve` spans count the path each window took.
"""

import time

import numpy as np
import pytest
import torch

from droplet_visual_odometry_tpu_torch.backend import ba, refine
from droplet_visual_odometry_tpu_torch.data import synthetic
from droplet_visual_odometry_tpu_torch.ops import cuda_ba
from droplet_visual_odometry_tpu_torch.utils import profiling

from test_torch_cuda_kernels import ba_window64

torch.set_num_threads(2)


@pytest.mark.parametrize("W,L,n_fixed", [(8, 200, 2), (4, 90, 1)])
def test_cpu_window_runs_the_plain_twin(W, L, n_fixed):
    """A CPU window takes the plain twin (run_ba_eager) through run_ba_cuda
    and through run_ba, bit for bit, and launches nothing."""
    window = ba_window64(W, W, L)
    cfg = ba.BAConfig(n_fixed=n_fixed)
    ref = ba.run_ba_eager(window, cfg)
    before = cuda_ba.LAUNCHES
    assert not ba.runs_in_kernel(window)
    for out in (cuda_ba.run_ba_cuda(window, cfg), ba.run_ba(window, cfg)):
        assert all(torch.equal(u, v) for u, v in zip(out, ref))
    assert cuda_ba.LAUNCHES == before and float(ref.final_cost) < float(ref.initial_cost)


@pytest.mark.parametrize("W,L,blocks", [
    (1, 1, 1), (8, 3, 3), (8, 8, 8), (8, 1000, 8), (8, 10**6, 8), (4, 300, 8),
    (18, 1000, 8), (19, 1000, None), (8, 0, None), (0, 100, None),
])
def test_plan_at_the_edges_of_its_shared_memory(W, L, blocks):
    """A cluster of 8 blocks, or one a landmark below 8 landmarks; W up to
    18, where a block's shared memory (smem_bytes, the source's
    smem_doubles) still fits the H100's 227 KB; nothing for an empty
    window."""
    assert cuda_ba.plan(W, L) == blocks
    assert cuda_ba.fits(W, L, torch.float64) == (blocks is not None)
    assert not cuda_ba.fits(W, L, torch.float32)
    if W in (18, 19):
        assert (cuda_ba.smem_bytes(W) <= cuda_ba.MAX_SMEM) == (W == 18)


def test_ba_solve_spans_count_the_path():
    """refine_trajectory on a float64 CPU loop: one `ba.solve` span a window
    run, each with ba_kernel = 0 (the kernel runs only on a CUDA device)."""
    seq = synthetic.render_sequence(synthetic.SyntheticConfig(
        n_frames=24, width=320, height=240, n_landmarks=300, orbit_sweep=0.6, dolly=0.5, loop=True))
    abs_poses = np.asarray(seq.marker_poses, np.float64)
    n_inliers = np.full(len(seq) - 1, 200)
    t0 = time.perf_counter()
    _, info = refine.refine_trajectory(torch.from_numpy(seq.frames).float(), abs_poses, n_inliers,
                                       np.asarray(seq.camera.K, np.float32), refine.RefineConfig(n_keypoints=256))
    solves = [r for r in profiling.snapshot(t0) if r.name == "ba.solve"]
    assert info["windows"] >= 1 and len(solves) == info["windows"]
    assert all(r.attrs["ba_kernel"] == 0 for r in solves)
