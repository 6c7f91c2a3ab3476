"""The port's multi-device layer vs the JAX reference (CPU): data-parallel
pair VO (parallel/sharding.py), process bring-up and the scaling harness
(parallel/launch.py), cli/scaling.py, and the device rule.

The reference runs on the suite's 8-device virtual CPU mesh
(tests/conftest.py); the port in one process (a size-1 mesh) and in 2
spawned gloo ranks (tests/torch_mp_worker.py). Inputs follow
tests/test_parallel.py: 9 frames at 256x192, K = 256, 256/64 hypotheses,
the reference's per-pair draws of pair_vo_batched(PRNGKey(0)) replayed.
Tolerances are stated per test.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.data import synthetic as jsynth
from droplet_visual_odometry_tpu.estimation.ransac import RansacConfig as JRansacConfig
from droplet_visual_odometry_tpu.estimation.vo import VOConfig as JVOConfig
from droplet_visual_odometry_tpu.parallel import sharding as jsharding

from droplet_visual_odometry_tpu_torch import convert
from droplet_visual_odometry_tpu_torch.cli import scaling as tscaling
from droplet_visual_odometry_tpu_torch.data import synthetic as tsynth
from droplet_visual_odometry_tpu_torch.estimation import vo as tvo
from droplet_visual_odometry_tpu_torch.parallel import launch as tlaunch
from droplet_visual_odometry_tpu_torch.parallel import sharding as tsharding

from torch_mp_worker import TIMEOUT_S, run_ranks

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ_CFG = dict(n_frames=9, width=256, height=192, n_landmarks=300)
RANSAC_KW = dict(n_hypotheses=256, lo_hypotheses=64)
# tests/test_torch_pipeline.py's hold on relative poses against the reference
# with its draws replayed (ROADMAP C.2: the GN scale of a pair may take another
# damped step).
REL_TOL = 5e-3


def jax_pair_draws(n: int, n_hyp: int, n_lo: int):
    """The reference's draws of pair_vo_batched(PRNGKey(0)) for n pairs:
    split(key, n) (sharding.py:82, as run_sequence at vo.py:189), uniform(k)
    for the hypotheses and fold_in(k, 1) for the LO round (ransac.py:88, 188)."""
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    u_hyp = np.stack([np.asarray(jax.random.uniform(k, (n_hyp * 8,))) for k in keys])
    u_lo = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (n_lo * 14,))) for k in keys])
    return torch.from_numpy(u_hyp), torch.from_numpy(u_lo)


def gt_errors(seq, rels):
    """Per-pair rotation (deg) and translation errors against the analytic
    ground truth (tests/test_parallel.py's measure)."""
    rots, trans = [], []
    for i, rel in enumerate(np.asarray(rels, np.float64)):
        gt = seq.marker_poses[i + 1].astype(np.float64) @ np.linalg.inv(seq.marker_poses[i].astype(np.float64))
        dR = rel[:3, :3].T @ gt[:3, :3]
        rots.append(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))
        trans.append(np.linalg.norm(rel[:3, 3] - gt[:3, 3]))
    return np.asarray(rots), np.asarray(trans)


@pytest.fixture(scope="module")
def pair():
    """Both packages' inputs, the reference's rels and the port's on one device."""
    jseq = jsynth.render_sequence(jsynth.SyntheticConfig(**SEQ_CFG))
    seq = tsynth.render_sequence(tsynth.SyntheticConfig(**SEQ_CFG))
    np.testing.assert_array_equal(seq.frames, jseq.frames)
    jcfg = JVOConfig(n_keypoints=256, ransac=JRansacConfig(**RANSAC_KW))
    cfg = convert.vo_config_from_dict(dataclasses.asdict(jcfg))
    frames = seq.frames.astype(np.float32)
    corners = np.nan_to_num(seq.marker_corners.astype(np.float32))
    mvalid = seq.marker_present[:-1] & seq.marker_present[1:]
    K = np.asarray(seq.camera.K, np.float32)
    args = (torch.from_numpy(frames[:-1]), torch.from_numpy(frames[1:]), torch.from_numpy(corners[:-1]),
            torch.from_numpy(corners[1:]), torch.from_numpy(mvalid), torch.from_numpy(K), seq.real_marker_length, cfg)
    u_hyp, u_lo = jax_pair_draws(len(seq) - 1, RANSAC_KW["n_hypotheses"], RANSAC_KW["lo_hypotheses"])
    ref = np.asarray(jsharding.pair_vo_batched(
        jax.random.PRNGKey(0), jnp.asarray(frames[:-1]), jnp.asarray(frames[1:]), jnp.asarray(corners[:-1]),
        jnp.asarray(corners[1:]), jnp.asarray(mvalid), jnp.asarray(K), seq.real_marker_length, jcfg))
    one = tsharding.shard_pair_vo(tsharding.make_mesh(device="cpu"), *args, u_hyp=u_hyp, u_lo=u_lo)
    return dict(seq=seq, args=args, u_hyp=u_hyp, u_lo=u_lo, ref=ref, one=one.numpy(), cfg=cfg)


@pytest.fixture(scope="module")
def ranks(pair, tmp_path_factory):
    """Two gloo ranks: shard_pair_vo on the pairs, then the scaling harness."""
    inputs = {"pair_vo_args": pair["args"], "u_hyp": pair["u_hyp"], "u_lo": pair["u_lo"]}
    return run_ranks(tmp_path_factory.mktemp("ranks"), ["pair_vo", "scaling"], inputs)


# --------------------------------------------------------------------------
# Data-parallel pair VO
# --------------------------------------------------------------------------


def _check_against_reference(pair, rels):
    np.testing.assert_allclose(rels, pair["ref"], atol=REL_TOL)
    rot, t = gt_errors(pair["seq"], rels)
    rot_ref, t_ref = gt_errors(pair["seq"], pair["ref"])
    print(f"rotation errors port {rot.round(3).tolist()} reference {rot_ref.round(3).tolist()}")
    # tests/test_parallel.py:66-68's bounds.
    assert rot.max() < 8.0 and rot_ref.max() < 8.0
    assert abs(rot.mean() - rot_ref.mean()) < 1.0
    assert abs(t.mean() - t_ref.mean()) < 0.05


def test_pair_vo_one_device_matches_reference(pair):
    """One device (a size-1 mesh, no process group): the reference's rels
    to 5e-3 with its draws replayed, errors within test_parallel's bounds,
    and shard_pair_vo equal to pair_vo_batched bit for bit."""
    _check_against_reference(pair, pair["one"])
    plain = tsharding.pair_vo_batched(*pair["args"], u_hyp=pair["u_hyp"], u_lo=pair["u_lo"], device="cpu")
    np.testing.assert_array_equal(pair["one"], plain.numpy())


def test_pair_vo_two_ranks_matches_reference(pair, ranks):
    """Two gloo ranks, 4 pairs each: every rank holds all 8 rels, the
    reference's to 5e-3, equal across ranks and to the one-device run bit
    for bit (each pair's arithmetic does not depend on its batch here)."""
    assert [r["mesh"] for r in ranks] == [(2, 0, "cpu", "frames"), (2, 1, "cpu", "frames")]
    for r in ranks:
        assert r["rels"].shape == (8, 4, 4)
        _check_against_reference(pair, r["rels"].numpy())
        np.testing.assert_array_equal(r["rels"].numpy(), pair["one"])


def test_pair_vo_uneven_batch_raises(ranks):
    """7 pairs over 2 ranks raise, as the reference's NamedSharding does."""
    for r in ranks:
        assert "7 pairs do not divide over 2 devices" in r["odd_batch"]


def test_pair_vo_seeded_draws_equal_run_sequence(pair):
    """pair_vo_batched draws its uniforms as run_sequence does (pair i from
    split(PRNGKey(seed), B)[i]), so on the same frames and seed its rels
    equal run_sequence's bit for bit (marker scale mode)."""
    seq, cfg = pair["seq"], pair["cfg"]
    rels = tsharding.pair_vo_batched(*pair["args"], seed=3, device="cpu")
    traj = tvo.run_sequence(torch.from_numpy(seq.frames).float(), seq.marker_corners, seq.marker_present,
                            seq.marker_poses[0], seq.camera.K, seq.real_marker_length, cfg, seed=3)
    np.testing.assert_array_equal(rels.numpy(), traj.rel_poses.numpy())


# --------------------------------------------------------------------------
# launch and the scaling harness
# --------------------------------------------------------------------------


def test_launch_initialize_single_process_noop(monkeypatch):
    """Without a coordinator or torchrun's variables, initialize is a no-op;
    this process is the coordinator and its mesh has one device."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tlaunch.initialize() is False
    assert tlaunch.is_coordinator()
    mesh = tlaunch.global_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)


@pytest.mark.parametrize("name", ["scaling_pair_vo", "scaling_ba"])
def test_scaling_harness_on_two_ranks(ranks, name):
    """measure_scaling_* over meshes of 1 and 2 ranks: both points on the
    coordinator, finite times, efficiency 1.0 at one device; the report
    carries eff=. Rank 1 is outside the 1-device mesh and skips it."""
    pts = ranks[0][name]
    assert [p["n_devices"] for p in pts] == [1, 2]
    assert all(p["throughput"] > 0 and np.isfinite(p["seconds"]) for p in pts)
    assert pts[0]["efficiency"] == 1.0
    assert [p["n_devices"] for p in ranks[1][name]] == [2]
    assert "eff=" in ranks[0]["scaling_report"]
    assert [r["is_coordinator"] for r in ranks] == [True, False]


def test_cli_scaling_spawn_cpu():
    """--spawn 2 --platform cpu: a 1-rank and a 2-rank gloo run over the
    same 2 pairs and 64 landmarks; the report has the reference's keys."""
    cmd = [sys.executable, "-m", "droplet_visual_odometry_tpu_torch.cli.scaling", "--spawn", "2",
           "--total-devices", "2", "--platform", "cpu", "--pairs-per-device", "1", "--ba"]
    # One intra-op thread a process: three processes share the test worker's cores.
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=REPO, timeout=2 * TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(report) == {"meta", "workloads"} and set(report["meta"]) == {"mode", "workload"}
    assert set(report["workloads"]) == {"pair_vo", "distributed_ba"}
    for w in report["workloads"].values():
        assert set(w) == {"1proc", "2proc", "cross_process_efficiency"}
        assert (w["1proc"]["n_devices"], w["2proc"]["n_devices"]) == (1, 2)
        assert w["cross_process_efficiency"] > 0


def test_cli_scaling_host_devices_rejected(capsys):
    """--host-devices has no counterpart when one rank is one device."""
    with pytest.raises(SystemExit):
        tscaling.main(["--host-devices", "2", "--platform", "cpu"])
    assert "one rank is one device" in capsys.readouterr().err


# --------------------------------------------------------------------------
# The device rule
# --------------------------------------------------------------------------

# entry point: (function whose `device` defaults to "cuda", or None for the CLI; its call here)
ENTRY_POINTS = {
    "make_mesh": (tsharding.make_mesh, lambda store: tsharding.make_mesh()),
    "initialize": (tlaunch.initialize, lambda store: tlaunch.initialize(f"file://{store}", 1, 0)),
    "measure_scaling_pair_vo": (tlaunch.measure_scaling_pair_vo, lambda store: tlaunch.measure_scaling_pair_vo([1], reps=1)),
    "measure_scaling_ba": (tlaunch.measure_scaling_ba, lambda store: tlaunch.measure_scaling_ba([1], reps=1)),
    "cli.scaling": (None, lambda store: tscaling.main(["--devices", "1"])),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_multi_device_entry_points_default_to_cuda(entry, tmp_path, monkeypatch):
    """Called without a device, each entry point runs on the card: here,
    without one, it raises before any process group comes up."""
    fn, call = ENTRY_POINTS[entry]
    if fn is not None:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(tmp_path / "store")
    assert not torch.distributed.is_initialized()
