"""The port's three CLIs (convert, run_experiment, analyze) and its YAML
config I/O vs the JAX reference's (CPU).

One recorded-data path end to end: a 12-frame 448x336 synthetic sequence
(the marker absent on two frames) written as a ROS1 bag with lz4 chunks by
tests/torch_bag_data.py, converted by both packages' `convert --bag`
(their .npz arrays equal), run by both `run_experiment --backend none`
(the same summary keys and config; the ATE within 1 cm, the replayed-draw
tolerance of ROADMAP C.2: both draw the same RANSAC samples for the seed,
and XLA's jit moves the 8-point solves), and read
back by both `analyze` on one TUM directory (reports within 1e-6). The JAX
reference runs one convert and one run_experiment call.
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from droplet_visual_odometry_tpu.cli import analyze as janalyze
from droplet_visual_odometry_tpu.cli import convert as jconvert
from droplet_visual_odometry_tpu.cli import run_experiment as jrun
from droplet_visual_odometry_tpu.estimation.ransac import RansacConfig as JRansacConfig
from droplet_visual_odometry_tpu.estimation.vo import VOConfig as JVOConfig
from droplet_visual_odometry_tpu.utils import config as jconfig

from droplet_visual_odometry_tpu_torch import convert as tbuild
from droplet_visual_odometry_tpu_torch.cli import analyze as tanalyze
from droplet_visual_odometry_tpu_torch.cli import convert as tconvert
from droplet_visual_odometry_tpu_torch.cli import run_experiment as trun
from droplet_visual_odometry_tpu_torch.data import sequence as tsequence
from droplet_visual_odometry_tpu_torch.data import synthetic as tsynth
from droplet_visual_odometry_tpu_torch.data.native_store import StoreReader
from droplet_visual_odometry_tpu_torch.utils import config as tconfig
from droplet_visual_odometry_tpu_torch.utils import profiling

import torch_bag_data as bags

SEQ_CFG = dict(n_frames=12, width=448, height=336, n_landmarks=350)
ATE_TOL = 1e-2
REPORT_TOL = 1e-6


def _json_docs(text: str) -> list[dict]:
    """The JSON objects a CLI printed, in order (other lines skipped)."""
    docs, dec, i = [], json.JSONDecoder(), text.find("{")
    while i >= 0:
        doc, end = dec.raw_decode(text, i)
        docs.append(doc)
        i = text.find("{", end)
    return docs


def _json_out(capsys) -> dict:
    """The first JSON object a CLI printed to stdout."""
    return _json_docs(capsys.readouterr().out)[0]


@pytest.fixture(scope="module")
def ingest(tmp_path_factory):
    """The sequence, its bag and calibration, and both packages' converted .npz."""
    d = tmp_path_factory.mktemp("ingest")
    seq = tsynth.render_sequence(tsynth.SyntheticConfig(**SEQ_CFG))
    seq.marker_present[5:7] = False
    seq.marker_corners[5:7] = np.nan
    bag, calib = str(d / "rec.bag"), str(d / "cam.yaml")
    bags.sequence_bag(bag, seq, "lz4")
    bags.write_calibration(calib, seq.camera)
    flags = ["--bag", bag, "--calibration", calib, "--marker-id", "0",
             "--marker-length", str(seq.real_marker_length), "--camera-frame-detections"]
    assert jconvert.main(flags + ["--out", str(d / "jax.npz")]) == 0
    assert tconvert.main(flags + ["--out", str(d / "port.npz"), "--vostore", str(d / "port.vost"),
                                  "--platform", "cpu"]) == 0
    return dict(seq=seq, dir=d, bag=bag, calib=calib, flags=flags, jax=str(d / "jax.npz"),
                port=str(d / "port.npz"), store=str(d / "port.vost"))


@pytest.fixture(scope="module")
def runs(ingest):
    """run_experiment --backend none on each package's converted sequence;
    the port's run also writes the plot, two pairs of debug images and a
    profile."""
    d = ingest["dir"]
    summaries = {}
    for name, main, extra in (
        ("jax", jrun.main, []),
        ("port", trun.main, ["--platform", "cpu", "--plot", str(d / "traj.png"), "--dump-matches", "2",
                             "--profile-dir", str(d / "prof")]),
    ):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["--sequence", ingest[name], "--out-dir", str(d / f"{name}_out"), "--backend", "none",
                         "--platform", "cpu", *extra]) == 0
        docs = _json_docs(buf.getvalue())
        summaries[name] = docs[0]
        if name == "port":
            summaries["debug"] = docs[1]
    return summaries


# --------------------------------------------------------------------------
# convert
# --------------------------------------------------------------------------


def test_convert_bag_equals_reference(ingest):
    """Every array of the two .npz files: equal, the marker poses within
    1e-6 (each package derives cTm from the quaternion in float32)."""
    with np.load(ingest["port"]) as p, np.load(ingest["jax"]) as j:
        assert sorted(p.files) == sorted(j.files)
        for k in j.files:
            if k == "marker_poses":
                np.testing.assert_allclose(p[k], j[k], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)
            assert p[k].dtype == j[k].dtype, k


def test_convert_bag_equals_sequence(ingest):
    """The converted sequence is the rendered one: frames, presence and
    corners equal, stamps to the bag's nanoseconds, poses within 1e-6 (the
    quaternion round trip), and the VOSTORE1 file holds the frames."""
    seq, got = ingest["seq"], tsequence.load(ingest["port"])
    np.testing.assert_array_equal(got.frames, seq.frames)
    np.testing.assert_array_equal(got.timestamps, bags.stored_stamps(seq.timestamps))
    np.testing.assert_array_equal(got.marker_present, seq.marker_present)
    np.testing.assert_array_equal(got.marker_corners, seq.marker_corners)  # NaN where absent
    np.testing.assert_allclose(got.marker_poses, seq.marker_poses, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.camera.K, seq.camera.K)
    with StoreReader(ingest["store"]) as r:
        np.testing.assert_array_equal(r.read(0, r.n), seq.frames)
        np.testing.assert_array_equal(r.timestamps(), got.timestamps)


def test_convert_runs_on_the_card_by_default(ingest, tmp_path):
    """Without --platform the ground truth goes to the card: here, none, so it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconvert.main(ingest["flags"] + ["--out", str(tmp_path / "x.npz")])
    assert not (tmp_path / "x.npz").exists()


# --------------------------------------------------------------------------
# run_experiment
# --------------------------------------------------------------------------


def test_run_experiment_summary_matches_reference(runs):
    j, p = runs["jax"], runs["port"]
    assert list(p) == list(j)
    assert p["config"] == j["config"]  # the same flags give the same VOConfig, field for field
    assert p["config"]["ransac"]["n_hypotheses"] == 1024  # the inherited CLI default (C.3)
    assert p["n_frames"] == j["n_frames"] == SEQ_CFG["n_frames"]
    assert p["median_matches"] == j["median_matches"]  # no draw comes before matching
    assert sorted(p["streams"]) == sorted(j["streams"])
    print(f"ATE port {p['ate_rmse_m']} reference {j['ate_rmse_m']}")
    assert abs(p["ate_rmse_m"] - j["ate_rmse_m"]) < ATE_TOL
    assert p["ok_fraction"] == 1.0 and np.isfinite(p["frames_per_second"])


def test_run_experiment_writes_plot_debug_images_and_trace(ingest, runs):
    d = ingest["dir"]
    assert (d / "traj.png").stat().st_size > 0
    written = runs["debug"]["debug_images"]
    names = sorted(os.path.basename(w) for w in written)
    # pairs 0->1 and 10->11 (the marker is on both frames of each), one keypoint overlay
    assert names == ["keypoints_00000.png", "marker_corners_00000.png", "marker_corners_00010.png",
                     "match_00000.png", "match_00010.png"]
    assert all(os.path.getsize(w) > 0 for w in written)
    with open(d / "prof" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    ours = {e["name"] for e in events if e.get("cat") == "recorder"}  # the recorder's spans beside the profiler's
    assert {"pipeline.run_experiment", "vo.run", "pipeline.metrics"} <= ours


def test_run_experiment_from_config_equals_flags(ingest, capsys):
    """--config with an ExperimentConfig YAML runs as the same flags do
    (backend none, scale-hold VO with 384 hypotheses: the config default)."""
    d = ingest["dir"]
    cfg = tconfig.ExperimentConfig(sequence=ingest["port"], out_dir=str(d / "cfg_out"), backend="none", seed=3)
    tconfig.save(str(d / "exp.yaml"), cfg)
    assert trun.main(["--config", str(d / "exp.yaml"), "--platform", "cpu"]) == 0
    from_cfg = _json_out(capsys)
    assert trun.main(["--sequence", ingest["port"], "--out-dir", str(d / "flag_out"), "--backend", "none",
                      "--ransac-hypotheses", "384", "--seed", "3", "--platform", "cpu"]) == 0
    from_flags = _json_out(capsys)
    assert from_cfg["config"] == from_flags["config"] == dataclasses.asdict(cfg.vo)
    for k in ("ate_rmse_m", "ate_max_m", "rpe_trans_rmse_m", "median_matches", "median_inliers"):
        assert from_cfg[k] == from_flags[k], k  # the same run on the CPU, bit for bit
    assert os.path.exists(d / "cfg_out" / "stamped_traj_estimate_absolute.txt")


def test_run_experiment_runs_on_the_card_by_default(ingest):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["--sequence", ingest["port"], "--backend", "none"])


# --------------------------------------------------------------------------
# analyze
# --------------------------------------------------------------------------


def _assert_close(got, want, path="report"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, str):
        assert got == want, path
    else:
        assert abs(got - want) <= REPORT_TOL, (path, got, want)


def test_analyze_equals_reference(ingest, runs, capsys):
    """Both analyses of the reference run's TUM directory, --align none and sim3."""
    out = str(ingest["dir"] / "jax_out")
    for align in ("none", "sim3"):
        assert janalyze.main([out, "--align", align, "--platform", "cpu"]) == 0
        want = _json_out(capsys)
        assert tanalyze.main([out, "--align", align]) == 0
        got = _json_out(capsys)
        assert "ate" in got and "gt_vo_difference" in got and len(got["per_stream_stats"]) == 6
        _assert_close(got, want)


def test_analyze_plot(ingest, capsys):
    plot_dir = ingest["dir"] / "plots"
    assert tanalyze.main([str(ingest["dir"] / "port_out"), "--plot-dir", str(plot_dir)]) == 0
    assert _json_out(capsys)["plot"] == str(plot_dir / "trajectory_3d.png")
    assert (plot_dir / "trajectory_3d.png").stat().st_size > 0


# --------------------------------------------------------------------------
# utils/config.py YAML I/O
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["default", "custom"])
def test_yaml_text_equals_reference(case, tmp_path):
    """The port writes the reference's text (yaml.safe_dump, field order),
    reads it back to an equal config, and reads the reference's file."""
    if case == "default":
        jcfg = jconfig.ExperimentConfig()
    else:
        jcfg = jconfig.ExperimentConfig(
            sequence="seq.npz", marker_id=3, real_marker_length=0.15, backend="ba", controlled=True,
            vo=JVOConfig(n_keypoints=128, frontend="sift", scale_mode="marker",
                         ransac=JRansacConfig(n_hypotheses=256, threshold_px=0.5)),
        )
    tcfg = tbuild.experiment_config_from_dict(dataclasses.asdict(jcfg))
    text = tconfig.to_yaml(tcfg)
    assert text == jconfig.to_yaml(jcfg)
    assert tconfig.from_yaml(text) == tcfg
    jconfig.save(str(tmp_path / "ref.yaml"), jcfg)
    assert tconfig.load(str(tmp_path / "ref.yaml")) == tcfg
    tconfig.save(str(tmp_path / "port.yaml"), tcfg)
    assert jconfig.load(str(tmp_path / "port.yaml")) == jcfg


def test_yaml_unknown_key_raises():
    with pytest.raises(KeyError, match="unknown"):
        tconfig.from_yaml("sequence: a\nnot_a_field: 1\n")
    with pytest.raises(KeyError, match="unknown VOConfig"):
        tconfig.from_yaml("vo:\n  n_keypoints: 64\n  bogus: 2\n")
    assert tconfig.from_yaml("") == tconfig.ExperimentConfig()
