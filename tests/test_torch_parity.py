"""The port's parity harness (droplet_visual_odometry_tpu_torch/parity.py)
against the repo's parity.py on the same inputs (CPU, quick size): the
copied reference chain bit for bit, the scenarios byte for byte, the
scoring, the Markdown text, the gates and the hold. The port's own rows
against the JAX package's are in test_torch_parity_ours.py.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import parity  # noqa: E402  (the repo-root harness)

from droplet_visual_odometry_tpu_torch import parity as tparity  # noqa: E402

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def quick_scenarios():
    return parity.scenarios(quick=True), tparity.scenarios(quick=True)


@pytest.mark.parametrize("scenario", ["clean", "distorted_1440"])
@pytest.mark.parametrize(
    "mode,faithful", [("orb", True), ("orb", False), ("knn_sift", False)], ids=["orb-faithful", "orb-intent", "knn_sift-intent"]
)
def test_reference_chain_equals_parity(quick_scenarios, scenario, mode, faithful):
    """The copied ReferenceVO/run_reference: the same frames, estimates and
    failure count bit for bit (the same OpenCV calls on the same inputs)."""
    seq = quick_scenarios[0][scenario]
    want = parity.run_reference(seq, mode=mode, faithful=faithful)
    got = tparity.run_reference(seq, mode=mode, faithful=faithful)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    assert np.isfinite(got[1]).all()


def test_copied_reference_source_equals_parity():
    """The reference chain is a copy: every function's source is parity.py's."""
    import inspect

    for name in ("_euler_roundtrip_rotation", "ReferenceVO", "run_reference", "_corner_jitter"):
        assert inspect.getsource(getattr(tparity, name)) == inspect.getsource(getattr(parity, name)), name
    assert tparity.REF_VARIANTS == [
        ("reference (faithful port)", dict(mode="orb", faithful=True), False),
        ("reference (intent, bugs fixed)", dict(mode="orb", faithful=False), True),
        ("reference knn_sift (intent)", dict(mode="knn_sift", faithful=False), True),
    ]


def test_scenarios_equal_parity(quick_scenarios):
    """The port's renderer gives parity.py's five scenarios byte for byte:
    frames, corners (NaN in the gap), presence, poses and the camera."""
    want, got = quick_scenarios
    assert list(got) == list(want)
    for name in want:
        w = want[name] if isinstance(want[name], list) else [want[name]]
        g = got[name] if isinstance(got[name], list) else [got[name]]
        assert len(g) == len(w)
        for gs, ws in zip(g, w):
            for field in ("frames", "marker_corners", "marker_present", "marker_poses", "timestamps"):
                np.testing.assert_array_equal(getattr(gs, field), np.asarray(getattr(ws, field)), err_msg=field)
            np.testing.assert_array_equal(gs.camera.K, np.asarray(ws.camera.K))
            np.testing.assert_array_equal(gs.camera.dist, np.asarray(ws.camera.dist))
            assert gs.real_marker_length == ws.real_marker_length


def test_marker_gap_and_jitter_helpers_equal(quick_scenarios):
    seq = quick_scenarios[1]["clean"]
    for fn, args in (("_marker_gap", (5, 17)), ("_corner_jitter", (1.5, 7))):
        got = getattr(tparity, fn)(seq, *args)
        want = getattr(parity, fn)(seq, *args)
        np.testing.assert_array_equal(got.marker_present, want.marker_present)
        np.testing.assert_array_equal(got.marker_corners, want.marker_corners)


def test_evaluate_agrees(quick_scenarios):
    """The port's metrics score the same trajectory as the JAX package's to 1e-9."""
    seq = quick_scenarios[1]["corner_noise_1px"]
    present = np.flatnonzero(seq.marker_present)
    rng = np.random.default_rng(3)
    est = np.asarray(seq.marker_poses, np.float64)[present].copy()
    est[:, :3, 3] += rng.normal(scale=0.05, size=(len(present), 3))
    got = tparity.evaluate(seq, present, est)
    want = parity.evaluate(seq, present, est)
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, (k, got[k], want[k])


def _results(default_ate=0.05, best_ours=0.04, ref=0.2):
    """A made-up results dict: two scenarios, reference and ours rows."""
    def row(a, seeds=1, **kw):
        return dict(ate_rmse_m=a, ate_max_m=2 * a, rpe_trans_rmse_m=a / 10, rpe_rot_rmse_deg=0.1, **kw, seeds=seeds)

    scen = {
        "reference (faithful port)": row(30.0, n_failures=2),
        "reference (intent, bugs fixed)": row(ref, n_failures=0, seeds=3),
        "reference knn_sift (intent)": row(ref + 0.01, n_failures=0, seeds=3),
        "ours none": row(0.06, seeds=3),
        "ours ba": row(best_ours),
        tparity.DEFAULT_LABEL: row(default_ate, seeds=3),
    }
    return {"clean": scen, "marker_gap": dict(scen)}


def test_format_md_identical_to_parity():
    res = _results()
    assert tparity.format_md(res) == parity.format_md(res)
    lost = _results(default_ate=0.3, best_ours=0.25)
    assert tparity.format_md(lost) == parity.format_md(lost)
    assert "**FAIL**" in tparity.format_md(lost)
    own = tparity.format_md(res, title="# T", command="python -m x")
    assert own.splitlines()[0] == "# T" and "`python -m x`" in own
    assert own.splitlines()[3:] == tparity.format_md(res).splitlines()[3:]


@pytest.mark.parametrize(
    "case,kw,quick,rc",
    [
        ("win", dict(), False, 0),
        ("default loses", dict(default_ate=0.25), False, 1),
        ("best ours loses", dict(default_ate=0.3, best_ours=0.21), False, 1),
        ("quick mode", dict(default_ate=0.3, best_ours=0.25), True, 0),
    ],
)
def test_exit_code_gates(case, kw, quick, rc, monkeypatch):
    """parity.py's two gates: non-zero when the default row or the best
    port row loses to the best reference row; quick mode never gates.
    (The hold is switched off here: no JAX row for these made-up scenarios.)"""
    monkeypatch.setattr(tparity, "JAX_ATE_RMSE", {})
    res = _results(**kw)
    assert tparity.exit_code(res, quick=quick) == rc, case
    assert bool(tparity.gate_failures(res)) == (case != "win")


def test_hold_against_the_jax_rows(monkeypatch):
    """Each port row within twice the JAX seed spread (the width of its
    range) of its JAX row, with its margin; a miss makes the exit code
    non-zero even where the gates pass. A row outside the JAX seeds' range
    is reported whether it holds or not."""
    monkeypatch.setattr(tparity, "JAX_ATE_RMSE", {"clean": {"ours none": 0.05, "ours ba": 0.041}})
    monkeypatch.setattr(tparity, "JAX_ATE_RANGE", {"clean": {"ours none": (0.048, 0.052),
                                                             "ours ba": (0.0407, 0.0413)}})
    res = _results()
    h = tparity.holds(res)
    assert set(h) == {"clean"} and set(h["clean"]) == {"ours none", "ours ba"}
    assert h["clean"]["ours none"] == dict(port=0.06, jax=0.05, diff=0.01, tol=0.008, margin=-0.002, ok=False,
                                           jax_range=[0.048, 0.052], in_range=False)
    assert h["clean"]["ours ba"]["ok"] and h["clean"]["ours ba"]["margin"] == 0.0002
    assert not h["clean"]["ours ba"]["in_range"]
    assert [m.split(":")[1].split(" ATE")[0].strip() for m in tparity.outside_range(h)] == ["ours none", "ours ba"]
    assert tparity.gate_failures(res) == []
    assert tparity.exit_code(res) == 1
    res["clean"]["ours none"] = dict(res["clean"]["ours none"], ate_rmse_m=0.0545)
    assert tparity.exit_code(res) == 0
    res["clean"]["ours none"] = dict(res["clean"]["ours none"], ate_rmse_m=0.0515)
    assert tparity.holds(res)["clean"]["ours none"]["in_range"]
    assert len(tparity.outside_range(tparity.holds(res))) == 1


def test_jax_rows_cover_every_full_size_row():
    """The harness holds every full-mode "ours" row of every scenario, and
    its JAX rows are PARITY.md's to the table's 4 decimals."""
    with open(os.path.join(os.path.dirname(parity.__file__), "PARITY.md")) as f:
        md = f.read()
    for name in ("clean", "corner_noise_1px", "marker_gap", "drift_loop", "distorted_1440"):
        labels = [r[0] for r in tparity.ours_rows(name)]
        assert set(labels) == set(tparity.JAX_ATE_RMSE[name]) == set(tparity.JAX_ATE_RANGE[name]), name
        section = md.split(f"## {name}\n", 1)[1].split("\n## ", 1)[0]
        for label in labels:
            line = next(ln for ln in section.splitlines() if ln.startswith(f"| {label} |"))
            assert f"{tparity.JAX_ATE_RMSE[name][label]:.4f}" == line.split("|")[2].strip(), (name, label)
            lo, hi = tparity.JAX_ATE_RANGE[name][label]
            assert lo < hi and lo <= tparity.JAX_ATE_RMSE[name][label] <= hi, (name, label)


def test_ours_rows_follow_parity_rules():
    """Row set, scale_mode rule (hold on marker_gap) and all_seeds flags."""
    assert [r[0] for r in tparity.ours_rows("clean", quick=True)] == ["ours none"]
    gap = {r[0]: r for r in tparity.ours_rows("marker_gap")}
    assert gap["ours none"][2] == gap["ours ba"][2] == "hold"
    assert {k for k, r in gap.items() if r[4]} == {"ours none", tparity.DEFAULT_LABEL}
    clean = {r[0]: r for r in tparity.ours_rows("clean")}
    assert clean["ours sift"] == ("ours sift", "none", "marker", "sift", False)
    assert "ours sift" not in {r[0] for r in tparity.ours_rows("drift_loop")}
    assert dataclasses.asdict(tparity.ours_config("marker", "surf"))["match_mode"] == "ratio"


def test_main_on_cuda_raises_without_gpu():
    """The harness runs on the card unless --device cpu: without one it
    raises through utils/device.resolve_device, before any scenario."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparity.main(["--quick", "--scenario", "clean"])


def test_run_scenario_is_run_all_of_one_scenario(monkeypatch):
    """run_scenario(name, seq) is run_all's rows of {name: seq}."""
    calls = []
    monkeypatch.setattr(tparity, "run_all", lambda scen, quick, device: (calls.append((scen, quick, device))
                                                                         or ({n: "rows" for n in scen}, {})))
    assert tparity.run_scenario("clean", "seq", True, "cpu") == "rows"
    assert calls == [({"clean": "seq"}, True, "cpu")]


def test_commit_name_stops_at_the_checkout(tmp_path, monkeypatch):
    """The commit of the checkout whose root holds the package; 'unknown'
    for a copy that is not a checkout itself, even inside another one."""
    import subprocess

    git = lambda cwd, *a: subprocess.run(["git", "-c", "user.name=t", "-c", "user.email=t@t", "-C", str(cwd), *a],
                                         capture_output=True, text=True, check=True).stdout.strip()
    outer = tmp_path / "outer"
    (outer / "copy" / "pkg").mkdir(parents=True)
    (outer / "f.txt").write_text("x")
    git(outer, "init", "-q")
    git(outer, "add", "f.txt")
    git(outer, "commit", "-q", "-m", "c")
    monkeypatch.setattr(tparity, "__file__", str(outer / "copy" / "pkg" / "parity.py"))
    assert tparity.commit_name().startswith("unknown")
    monkeypatch.setattr(tparity, "__file__", str(outer / "pkg" / "parity.py"))
    assert tparity.commit_name() == git(outer, "rev-parse", "HEAD")
    (outer / "f.txt").write_text("y")
    assert tparity.commit_name() == git(outer, "rev-parse", "HEAD") + " + uncommitted changes"
