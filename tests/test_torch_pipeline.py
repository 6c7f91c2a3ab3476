"""The port's slice as a whole vs the JAX reference (CPU), plus the port's rules.

Slice: run_sequence on a 10-frame 640x480 synthetic sequence with the
default VOConfig, the port replaying the reference's per-pair RANSAC draws
(jax.random.split(key, n-1), vo.py:189); run_experiment(backend="none")
output files; the hold fill and pose chain; the renderer; the .npz format
across packages.
"""

import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu import pipeline as jpipe
from droplet_visual_odometry_tpu.data import sequence as jsequence
from droplet_visual_odometry_tpu.core import se3 as jse3
from droplet_visual_odometry_tpu.data import synthetic as jsynth
from droplet_visual_odometry_tpu.estimation.vo import VOConfig as JVOConfig
from droplet_visual_odometry_tpu.eval import tum as jtum

from droplet_visual_odometry_tpu_torch import convert
from droplet_visual_odometry_tpu_torch import pipeline as tpipe
from droplet_visual_odometry_tpu_torch.core import se3 as tse3
from droplet_visual_odometry_tpu_torch.data import sequence as tsequence
from droplet_visual_odometry_tpu_torch.data import synthetic as tsynth
from droplet_visual_odometry_tpu_torch.estimation import vo as tvo
from droplet_visual_odometry_tpu_torch.eval import metrics as tmetrics
from droplet_visual_odometry_tpu_torch.eval import tum as ttum

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ_CFG = dict(n_frames=10, width=640, height=480, n_landmarks=350)


@pytest.fixture(scope="module")
def seqs():
    j = jsynth.render_sequence(jsynth.SyntheticConfig(**SEQ_CFG))
    t = tsynth.render_sequence(tsynth.SyntheticConfig(**SEQ_CFG))
    return j, t


@pytest.fixture(scope="module")
def jax_run(seqs, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_exp"))
    return jpipe.run_experiment(seqs[0], JVOConfig(), out_dir=out, seed=0), out


@pytest.fixture(scope="module")
def replayed(seqs):
    """The port's run_sequence with the reference's draws for seed 0."""
    seq = seqs[1]
    keys = jax.random.split(jax.random.PRNGKey(0), len(seq) - 1)
    u_hyp = np.stack([np.asarray(jax.random.uniform(k, (384 * 8,))) for k in keys])
    u_lo = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), (128 * 14,))) for k in keys])
    traj = tvo.run_sequence(
        torch.from_numpy(seq.frames).float(), seq.marker_corners, seq.marker_present, seq.marker_poses[0],
        seq.camera.K, seq.real_marker_length, tvo.VOConfig(),
        u_hyp=torch.from_numpy(u_hyp), u_lo=torch.from_numpy(u_lo),
    )
    return tvo.VOTrajectory(*(t.numpy() for t in traj))


@pytest.fixture(scope="module")
def port_run(seqs, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_exp"))
    return tpipe.run_experiment(seqs[1], tvo.VOConfig(), out, 0, backend="none", device="cpu"), out


# --------------------------------------------------------------------------
# The slice against the reference
# --------------------------------------------------------------------------


def test_renderer_frames_identical(seqs):
    j, t = seqs
    np.testing.assert_array_equal(t.frames, j.frames)
    for f in ("timestamps", "marker_corners", "marker_poses", "marker_present", "marker_ids", "gt_poses", "landmarks"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    np.testing.assert_array_equal(t.camera.K, np.asarray(j.camera.K))


def test_run_sequence_matches_reference(jax_run, replayed):
    """Identical frontend -> identical match counts; with the reference's
    draws replayed, identical inlier counts except where XLA's fused f32
    tips an MSAC near-tie (<= 1 pair of 9, within 2%); relative poses to
    5e-3 (the GN scale of a pair may take a different damped step)."""
    ref = jax_run[0].trajectory
    np.testing.assert_array_equal(replayed.n_matches, np.asarray(ref.n_matches))
    ni, ni_ref = replayed.n_inliers, np.asarray(ref.n_inliers)
    print(f"n_inliers port {ni.tolist()} reference {ni_ref.tolist()}")
    assert (ni != ni_ref).sum() <= 1
    assert np.all(np.abs(ni - ni_ref) <= 0.02 * ni_ref)
    np.testing.assert_array_equal(replayed.ok, np.asarray(ref.ok))
    np.testing.assert_array_equal(replayed.scale_ok, np.asarray(ref.scale_ok))
    np.testing.assert_allclose(replayed.rel_poses, np.asarray(ref.rel_poses), atol=5e-3)
    np.testing.assert_allclose(replayed.abs_poses, np.asarray(ref.abs_poses), atol=5e-3)


def test_replayed_ate_matches_reference(seqs, jax_run, replayed):
    """ATE of the replayed port trajectory within 2 mm of the reference's
    (pose agreement above bounds it; measured difference well below)."""
    seq = seqs[1]
    gt_cam = np.linalg.inv(np.asarray(seq.marker_poses, np.float64)[seq.marker_present])
    vo_cam = np.linalg.inv(np.asarray(replayed.abs_poses, np.float64)[seq.marker_present])
    ate = tmetrics.ate(gt_cam, vo_cam).rmse
    print(f"ATE port (replayed draws) {ate} reference {jax_run[0].ate.rmse}")
    assert abs(ate - jax_run[0].ate.rmse) < 2e-3


def test_run_experiment_streams_match_reference(seqs, jax_run, port_run):
    """Same six file names and line format; the absolute ground truth
    byte-identical, the derived ground truth to f32 ulps, and the VO streams
    close, with the port's default draws (the reference's for seed 0): the
    bounds of test_run_sequence_matches_reference and
    test_replayed_ate_matches_reference (poses 5e-3, the velocities that
    over dt = 0.05 s, ATE 2 mm)."""
    (jres, jdir), (tres, tdir) = jax_run, port_run
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == sorted(ttum.STREAM_NAMES)
    assert ttum.STREAM_NAMES == jtum.STREAM_NAMES
    for name in ttum.STREAM_NAMES:
        with open(os.path.join(tdir, name)) as f:
            t_lines = f.read().splitlines()
        with open(os.path.join(jdir, name)) as f:
            j_lines = f.read().splitlines()
        assert len(t_lines) == len(j_lines)
        assert all(len(line.split()) == 8 for line in t_lines)
        if name == "stamped_ground_truth_absolute.txt":
            assert t_lines == j_lines  # no arithmetic on the way: the same f32 values
            continue
        t_stamps, t_poses = ttum.read_tum(os.path.join(tdir, name))
        j_stamps, j_poses = jtum.read_tum(os.path.join(jdir, name))
        np.testing.assert_array_equal(t_stamps, j_stamps)
        if "ground_truth" in name:  # one f32 4x4 product or difference: ulps
            tol = 1e-5
        else:  # the same draws: the replayed-draw bound on poses, and
            tol = 5e-3 / 0.05 if "velocity" in name else 5e-3  # velocity divides by dt = 0.05 s
        np.testing.assert_allclose(t_poses, j_poses, atol=tol)
    assert np.all(tres.trajectory.ok)
    print(f"ATE port {tres.ate.rmse} reference {jres.ate.rmse}")
    assert abs(tres.ate.rmse - jres.ate.rmse) < 2e-3
    np.testing.assert_allclose(tres.gt_rel, jres.gt_rel, atol=1e-6)


def test_hold_mode_fills_absent_marker_scales(seqs):
    seq = seqs[1]
    present = seq.marker_present.copy()
    present[3:6] = False
    cfg = dataclasses.replace(tvo.VOConfig(), scale_mode="hold")
    traj = tvo.run_sequence(
        torch.from_numpy(seq.frames).float(), seq.marker_corners, present, seq.marker_poses[0],
        seq.camera.K, seq.real_marker_length, cfg, seed=1,
    )
    ok = traj.scale_ok.numpy()
    s = traj.scales.numpy()
    assert not ok[2:6].any() and ok[:2].all()
    np.testing.assert_array_equal(s[2:6], np.full(4, s[1]))
    t_norm = np.linalg.norm(traj.rel_poses[:, :3, 3].numpy(), axis=-1)
    np.testing.assert_allclose(t_norm, s, rtol=1e-5)


# --------------------------------------------------------------------------
# Sequence-level pieces of vo.py
# --------------------------------------------------------------------------


def test_hold_fill_equals_associative_scan():
    rng = np.random.default_rng(10)
    scales = rng.uniform(0.5, 2.0, size=30).astype(np.float32)
    ok = rng.uniform(size=30) > 0.6
    ok[:3] = False

    def last_valid(a, b):
        return (jnp.where(b[1], b[0], a[0]), a[1] | b[1])

    for init in (1.0, 0.7):
        s_seed = jnp.concatenate([jnp.asarray([init], jnp.float32), jnp.asarray(scales)])
        v_seed = jnp.concatenate([jnp.asarray([False]), jnp.asarray(ok)])
        ref = np.asarray(jax.lax.associative_scan(last_valid, (s_seed, v_seed))[0][1:])
        out = tvo.hold_fill(torch.from_numpy(scales), torch.from_numpy(ok), init).numpy()
        np.testing.assert_array_equal(out, ref)


def test_chain_poses_equals_associative_scan():
    """A prefix loop vs a tree-ordered scan of 4x4 products: the same
    products in another association order, 1e-5 over 20 steps."""
    rng = np.random.default_rng(11)
    rels = np.stack(
        [np.asarray(tse3.se3_exp(torch.from_numpy(rng.normal(scale=0.05, size=6).astype(np.float32)))) for _ in range(20)]
    )
    init = np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(size=6), jnp.float32)))
    chain = jnp.concatenate([jnp.asarray(init)[None], jnp.asarray(rels)], axis=0)
    ref = np.asarray(jax.lax.associative_scan(lambda a, b: b @ a, chain))
    out = tvo.chain_poses(torch.from_numpy(init), torch.from_numpy(rels)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_se3_functions_agree():
    rng = np.random.default_rng(12)
    xi = rng.normal(scale=0.7, size=(16, 6)).astype(np.float32)
    xi[0] = 0.0
    T_ref = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    T = tse3.se3_exp(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(T, T_ref, atol=2e-6)
    for fn in ("rotmat_to_quat", "so3_log"):
        ref = np.asarray(getattr(jse3, fn)(jnp.asarray(T_ref[:, :3, :3])))
        out = getattr(tse3, fn)(torch.from_numpy(T_ref[:, :3, :3])).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-6)
    q = np.asarray(jse3.rotmat_to_quat(jnp.asarray(T_ref[:, :3, :3])))
    np.testing.assert_allclose(tse3.quat_to_rotmat(torch.from_numpy(q)).numpy(),
                               np.asarray(jse3.quat_to_rotmat(jnp.asarray(q))), atol=1e-6)
    np.testing.assert_allclose(tse3.inverse(torch.from_numpy(T_ref)).numpy(),
                               np.asarray(jse3.inverse(jnp.asarray(T_ref))), atol=1e-6)
    np.testing.assert_allclose(tse3.so3_exp(torch.from_numpy(xi[:, 3:])).numpy(),
                               np.asarray(jse3.so3_exp(jnp.asarray(xi[:, 3:]))), atol=2e-6)


# --------------------------------------------------------------------------
# Host data: distortion, preprocessor, .npz format, configs
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def distorted():
    cfg = dict(n_frames=3, width=160, height=120, fx=140.0, fy=140.0, n_landmarks=80,
               distortion=np.array([-0.2, 0.05, 0.001, -0.001, 0.0]))
    return jsynth.render_sequence(jsynth.SyntheticConfig(**cfg)), tsynth.render_sequence(tsynth.SyntheticConfig(**cfg))


def test_distorted_preprocessor_matches_reference(distorted):
    j, t = distorted
    np.testing.assert_array_equal(t.frames, j.frames)
    K_ref = np.asarray(jpipe.effective_K(j))
    K = tpipe.effective_K(t)
    np.testing.assert_allclose(K, K_ref, rtol=1e-5)
    np.testing.assert_allclose(
        tpipe.effective_marker_corners(t, K), jpipe.effective_marker_corners(j, K_ref), atol=1e-3
    )
    ref = np.asarray(jpipe.preprocess_frames(j))
    out = tpipe.preprocess_frames(t, "cpu").numpy()
    np.testing.assert_allclose(out, ref, atol=1e-2)  # bilinear weights from f32 maps: ~1e-4 px


def test_npz_round_trips_across_packages(seqs, tmp_path):
    j, t = seqs
    jsequence.save(str(tmp_path / "j.npz"), j)
    tsequence.save(str(tmp_path / "t.npz"), t)
    from_j = tsequence.load(str(tmp_path / "j.npz"))
    from_t = jsequence.load(str(tmp_path / "t.npz"))
    for a, b in ((from_j, j), (from_t, t)):
        for f in ("frames", "timestamps", "marker_corners", "marker_poses", "marker_present", "gt_poses"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        np.testing.assert_array_equal(np.asarray(a.camera.K), np.asarray(b.camera.K))
        assert (a.camera.width, a.camera.height, a.real_marker_length) == (b.camera.width, b.camera.height, b.real_marker_length)


def test_convert_builds_equal_configs_and_camera(seqs):
    j = seqs[0]
    jcfg = dataclasses.replace(JVOConfig(), n_keypoints=256, scale_mode="hold")
    tcfg = convert.vo_config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tvo.VOConfig()) == dataclasses.asdict(JVOConfig())
    assert convert.ransac_config_from_dict(dataclasses.asdict(jcfg.ransac)) == tcfg.ransac
    cam = convert.camera_from_arrays(np.asarray(j.camera.K), np.asarray(j.camera.dist), j.camera.width, j.camera.height)
    np.testing.assert_array_equal(cam.K, np.asarray(j.camera.K))
    np.testing.assert_array_equal(cam.dist, np.asarray(j.camera.dist))


@pytest.mark.parametrize("controlled", [False, True])
def test_load_calibration_equal(tmp_path, controlled):
    """Both calibration YAML schemas parse to the reference's camera."""
    from droplet_visual_odometry_tpu.core import camera as jcamera
    from droplet_visual_odometry_tpu_torch.core import camera as tcamera

    K = [1170.5, 0.0, 719.5, 0.0, 1168.25, 539.5, 0.0, 0.0, 1.0]
    dist = [-0.21, 0.05, 0.001, -0.002]  # four coefficients: k3 is padded with 0
    if controlled:
        text = f"camera_matrix: {{data: {K}}}\ndistortion_coefficients: {{data: {dist}}}\n"
    else:
        text = f"intrinsic_coeffs: [{K}]\ndistortion_coeffs: [{dist}]\nimage_width: 1440\nimage_height: 1080\n"
    path = tmp_path / "calib.yaml"
    path.write_text(text)
    ref = jcamera.load_calibration(str(path), controlled=controlled)
    cam = tcamera.load_calibration(str(path), controlled=controlled)
    np.testing.assert_array_equal(cam.K, np.asarray(ref.K))
    np.testing.assert_array_equal(cam.dist, np.asarray(ref.dist))
    assert (cam.width, cam.height) == (ref.width, ref.height)


# --------------------------------------------------------------------------
# Rules of the port
# --------------------------------------------------------------------------


def test_port_imports_without_jax():
    """With jax and the repo-root parity.py and bench.py blocked, the whole
    port (its parity and bench harnesses included) imports and scores a CPU
    tensor."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['parity'] = None\n"
        "sys.modules['bench'] = None\n"
        "import droplet_visual_odometry_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import torch\n"
        "from droplet_visual_odometry_tpu_torch.frontend import fast\n"
        "s = fast.fast_score_cuda(torch.full((1, 32, 32), 10.0), 20.0, 9)\n"
        "assert s.shape == (1, 32, 32) and not any(k.startswith('jax') and sys.modules[k] for k in sys.modules)\n"
        "assert {'droplet_visual_odometry_tpu_torch.parity', 'droplet_visual_odometry_tpu_torch.bench'} <= set(sys.modules)\n"
        "assert not any(k.split('.')[0] == 'droplet_visual_odometry_tpu' for k in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=REPO)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_cuda_device_raises_without_gpu(seqs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.run_experiment(seqs[1], tvo.VOConfig(), device="cuda")


@pytest.mark.parametrize("entry", ["make_preprocessor", "preprocess_frames", "run_experiment"])
def test_entry_points_default_to_cuda(seqs, entry):
    """Called without a device, each entry point runs on the card: here,
    without one, it raises rather than falling back to the CPU."""
    fn = getattr(tpipe, entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(seqs[1])


def test_pose_graph_defaults_to_cuda(seqs):
    """backend="pose_graph" called without a device runs on the card: here,
    without one, it raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.run_experiment(seqs[1], tvo.VOConfig(scale_mode="hold"), backend="pose_graph")


@pytest.mark.parametrize("kwargs", [dict(backend="ba"), dict(stream=True), dict(checkpoint_path="ck.npz")])
def test_stream_and_ba_default_to_cuda(seqs, kwargs):
    """Streaming, checkpoint/resume and backend="ba" called without a device
    run on the card: here, without one, they raise rather than falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.run_experiment(seqs[1], tvo.VOConfig(scale_mode="hold"), **kwargs)


def test_unknown_backend_raises(seqs):
    with pytest.raises(ValueError, match="unknown backend"):
        tpipe.run_experiment(seqs[1], tvo.VOConfig(), backend="bundle", device="cpu")


def test_run_experiment_parameters_in_reference_order():
    """The positional parameters of run_experiment are the reference's, in
    its order and with its defaults (checkpoint_chunk=256 before stream);
    the port adds only the keyword-only device."""
    ref = inspect.signature(jpipe.run_experiment).parameters
    port = inspect.signature(tpipe.run_experiment).parameters
    positional = [n for n, p in port.items() if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert positional == list(ref)
    assert [n for n in port if n not in ref] == ["device"] and port["device"].kind == inspect.Parameter.KEYWORD_ONLY
    for name in positional:
        if ref[name].default is not inspect.Parameter.empty and name != "cfg":
            assert port[name].default == ref[name].default, name
    assert port["checkpoint_chunk"].default == 256
