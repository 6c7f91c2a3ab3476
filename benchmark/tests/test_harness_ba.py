"""The windowed-BA cell euroc_mav_752.ba: found by name, its driver's
numbers on a tiny CPU clip, its readers on a traced CPU run, and the plain
reference's refined gap failing when one LM step is damped otherwise."""

import json
import os

import pytest
import torch
from harness_tiny import BENCH, REPO, drive, make_checkout

from vobench import cells

CELL = "euroc_mav_752.ba"
NEW_READERS = ("ba_ms.seq", "ba_host_ms.seq", "ba_solve_ms.seq", "ba_accept_pct.seq")
OLD_READERS = ("vo_ms_per_frame.seq", "vo_frontend_ms_per_frame.seq", "vo_solver_ms_per_frame.seq",
               "device_idle_pct.seq", "upload_ms.seq", "pipeline_eval_ms.seq")
TINY_FRAMES = 36  # of 376x240: the configuration's camera at half size, 7.5 cm a frame: windows of well-held tracks


def tiny_config() -> dict:
    """The configuration with its camera halved (the same field of view)."""
    cfg = cells.config(cells.spec(REPO), "euroc_mav_752")
    cam = cfg["camera"]
    cfg["camera"] = dict(cam, width=376, height=240, fx=cam["fx"] / 2, fy=cam["fy"] / 2,
                         cx=(cam["cx"] + 0.5) / 2 - 0.5, cy=(cam["cy"] + 0.5) / 2 - 0.5)
    return cfg


def tiny_traffic() -> dict:
    return dict(cells.traffic("ba"), clip_frames=TINY_FRAMES, sequence_frames=TINY_FRAMES, tum_files=False)


def test_cell_resolves_by_name():
    bench = cells.spec(REPO)
    wl = cells.workload(bench, CELL)
    assert wl["chips"] == 1 and wl["config"] == "euroc_mav_752" and wl["traffic"] == "ba"
    config = cells.config(bench, "euroc_mav_752")
    assert config["camera"]["width"] == 752 and config["vo"]["n_levels"] == 8 and config["refine"]["n_keypoints"] == 1000
    assert "sequence_frames" in config["reduced"]
    assert next(c for c in bench["configs"] if c["name"] == "euroc_mav_752")["reduced"] == ["sequence_frames"]
    traffic = cells.traffic("ba")
    assert traffic["driver"] == "ba" and traffic["backend"] == "ba" and traffic["sequence_frames"] == 1200
    driver = cells.module("drivers", "ba")
    for fn in ("setup", "run_window", "trace_targets", "end_to_end", "outputs", "reference_outputs",
               "control_outputs", "numbers"):
        assert callable(getattr(driver, fn)), fn
    assert set(cells.limits(CELL)) == {"rel_rot_gap_deg", "rel_trans_gap_m", "traj_gap_m", "refined_gap_m"}
    assert {m["name"] for m in cells.end_to_end(bench, CELL)} == {"seq_fps", "device_mem_gib", "setup_s"}
    layer = {m["name"] for m in cells.per_layer(bench, CELL)}
    assert layer == set(NEW_READERS) | set(OLD_READERS)
    for name in layer:
        assert callable(cells.module("metrics", name).read)


@pytest.fixture(scope="module")
def tiny_run():
    """The ba driver's set-up, one call and the reference's VO on the tiny
    clip, in this process on the CPU."""
    driver = cells.module("drivers", "ba")
    state = driver.setup(tiny_config(), tiny_traffic(), 2**31 + 13, "cpu", workers=2)
    out = [driver.call(state, 0)]
    yield driver, state, out, driver.reference_outputs(state, out)
    state.close()


def test_ba_driver_numbers_on_a_tiny_clip(tiny_run):
    """Every number of the cell's limits is computed, and within its limit."""
    from vobench.compare import judge

    driver, state, out, ref = tiny_run
    nums = driver.numbers(state, out, ref)
    ok, lines = judge(nums, cells.limits(CELL))
    assert ok, lines
    assert not (out[0]["refined"] == state.seq.marker_poses).all()


def test_differently_damped_step_fails_refined_gap(tiny_run, monkeypatch):
    """A reference whose first LM step of every window is damped by the
    largest lambda instead of init_lambda leaves the windows nearly where
    VO put them: refined_gap_m fails its limit."""
    from plainref.backend import ba as ref_ba

    driver, state, out, ref = tiny_run
    step, calls = ref_ba.lm_step, []

    def damped(poses, points, lam, *args):
        if len(calls) % ref_ba.BAConfig().iters == 0:  # a window's first step
            lam = torch.full_like(lam, 1e6)
        calls.append(1)
        return step(poses, points, lam, *args)

    monkeypatch.setattr(ref_ba, "lm_step", damped)
    nums = driver.numbers(state, out, ref)
    assert nums["refined_gap_m"] > cells.limits(CELL)["refined_gap_m"]["limit"], nums


def test_readers_on_a_traced_cpu_run(tmp_path):
    """A traced CPU run of the tiny BA cell through run_cell: the host
    readers and the acceptance share read; the device ones find nothing on
    the CPU and are left out."""
    root = make_checkout(str(tmp_path))
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "tiny_euroc.json"), "w") as f:
        json.dump(dict(tiny_config(), name="tiny_euroc"), f)
    with open(os.path.join(b, "traffic", "ba_t.json"), "w") as f:
        json.dump(tiny_traffic(), f)
    cell = "tiny_euroc.ba_t"
    with open(os.path.join(BENCH, "limits", f"{CELL}.json")) as src, open(os.path.join(b, "limits", f"{cell}.json"), "w") as f:
        f.write(src.read())
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_euroc", "source": "a test's camera", "file": "benchmark/configs/tiny_euroc.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": cell, "config": "tiny_euroc", "traffic": "ba_t", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(cell)
    with open(path, "w") as f:
        json.dump(bench, f)
    body = f"""
res, lines = run.run_cell({cell!r}, 2**31 + 17, 0.5, True, device="cpu", workers=2)
print(json.dumps(dict(res, lines=lines)))
"""
    res = drive(root, body)
    assert res["correct"] is True, res["lines"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert {"ba_ms.seq", "ba_host_ms.seq", "ba_accept_pct.seq", "pipeline_eval_ms.seq", "vo_ms_per_frame.seq"} <= set(got)
    assert "ba_solve_ms.seq" not in got  # a device interval: the card's only
    assert 0 < got["ba_host_ms.seq"] < got["ba_ms.seq"]
    assert 0 <= got["ba_accept_pct.seq"] <= 100
