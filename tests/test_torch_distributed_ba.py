"""Distributed Schur-complement BA (parallel/distributed_ba.py) vs the JAX
reference (CPU).

Windows from tests/test_backend.py:make_ba_problem, carried across with
convert.ba_window_from_jax: the reference's run_ba_distributed over
make_mesh(4, "landmarks") on the suite's 8-device virtual CPU mesh, and its
run_ba, against the port's run_ba_distributed on 2 spawned gloo ranks and
its run_ba. The reference's own tolerances (tests/test_distributed_ba.py):
poses 2e-3, points 2e-2 (the padded tail ignored), final cost rtol 0.05.
"""

import numpy as np
import pytest
import torch

from droplet_visual_odometry_tpu.backend import ba as jba
from droplet_visual_odometry_tpu.parallel import distributed_ba as jdba
from droplet_visual_odometry_tpu.parallel import sharding as jsharding

from droplet_visual_odometry_tpu_torch import convert
from droplet_visual_odometry_tpu_torch.backend import ba as tba
from droplet_visual_odometry_tpu_torch.parallel import distributed_ba as tdba

from test_backend import make_ba_problem
from torch_mp_worker import run_ranks

torch.set_num_threads(2)

# name: make_ba_problem arguments. "match" and "improves" are
# tests/test_distributed_ba.py's two windows; "odd" has L = 121, so the
# port's 2 ranks pad one landmark (and the reference's 4 devices three).
PROBLEMS = {
    "match": dict(W=6, L=120, noise_px=0.5, seed=1),
    "improves": dict(W=5, L=96, noise_px=0.3, pose_noise=0.03, seed=2),
    "odd": dict(W=6, L=121, noise_px=0.5, seed=3),
}


@pytest.fixture(scope="module")
def problems():
    """{name: (reference window, gt poses, gt points, the port's window)}."""
    out = {}
    for name, kw in PROBLEMS.items():
        window, gt_poses, gt_pts = make_ba_problem(**kw)
        out[name] = (window, gt_poses, gt_pts, convert.ba_window_from_jax(window, device="cpu"))
    return out


@pytest.fixture(scope="module")
def ranks(problems, tmp_path_factory):
    inputs = {"ba_windows": {name: (p[3], tba.BAConfig()) for name, p in problems.items()}}
    return run_ranks(tmp_path_factory.mktemp("ba_ranks"), ["ba"], inputs)


def test_ba_window_from_jax_carries_the_window(problems):
    for window, _, _, tw in problems.values():
        for a, b in zip(tw, window):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert tw.obs_mask.dtype == torch.bool


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_pad_landmarks_equals_reference(problems, n_devices):
    window, _, _, tw = problems["odd"]
    ref = jdba._pad_landmarks(window, n_devices)
    out = tdba._pad_landmarks(tw, n_devices)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["match", "odd"])
def test_distributed_matches_reference_and_single_device(problems, ranks, name):
    """2 ranks against the reference's 4-device run and single-device run_ba
    and against the port's run_ba: poses 2e-3, points 2e-2, final cost
    rtol 0.05; the cost falls tenfold; RMS within 1e-3 px of run_ba's;
    both ranks hold the same result bit for bit."""
    window, _, gt_pts, tw = problems[name]
    L = gt_pts.shape[0]
    out, other = (r["ba_" + name] for r in ranks)
    for key in ("poses", "points", "final_cost", "rms_px"):
        torch.testing.assert_close(out[key], other[key], rtol=0, atol=0)
    assert out["points"].shape == (L + (-L) % 2, 3)
    ref = jdba.run_ba_distributed(jsharding.make_mesh(4, axis_name="landmarks"), window, jba.BAConfig())
    ref_single = jba.run_ba(window, jba.BAConfig())
    single = tba.run_ba(tw, tba.BAConfig())
    print(f"{name}: poses vs run_ba {float((out['poses'] - single.poses).abs().max()):.3e}, vs the reference "
          f"{float(np.abs(out['poses'].numpy() - np.asarray(ref.poses)).max()):.3e}; cost "
          f"{float(out['initial_cost']):.4f} -> {float(out['final_cost']):.6f} (reference {float(ref.final_cost):.6f})")
    assert float(out["final_cost"]) < 0.1 * float(out["initial_cost"])
    for poses, points, cost in ((np.asarray(ref.poses), np.asarray(ref.points)[:L], float(ref.final_cost)),
                                (np.asarray(ref_single.poses), np.asarray(ref_single.points), float(ref_single.final_cost)),
                                (single.poses.numpy(), single.points.numpy(), float(single.final_cost))):
        np.testing.assert_allclose(out["poses"].numpy(), poses, atol=2e-3)
        np.testing.assert_allclose(out["points"].numpy()[:L], points, atol=2e-2)
        np.testing.assert_allclose(float(out["final_cost"]), cost, rtol=0.05)
    np.testing.assert_allclose(float(out["rms_px"]), float(single.rms_px), atol=1e-3)


def test_distributed_improves_over_init(problems, ranks):
    """tests/test_distributed_ba.py:43-50 on 2 ranks: every pose within 2 cm
    of the ground truth."""
    _, gt_poses, _, _ = problems["improves"]
    est = ranks[0]["ba_improves"]["poses"].numpy()
    for w in range(len(gt_poses)):
        dt = np.linalg.norm(est[w][:3, 3] - gt_poses[w][:3, 3])
        assert dt < 0.02, (w, dt)
