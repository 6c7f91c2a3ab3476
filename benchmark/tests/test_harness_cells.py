"""BENCHMARK.json against the contract, and every piece found by name."""

import json
import os
import re

import pytest
from harness_tiny import REPO, drive, run_cell_body

from vobench import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cells.spec(REPO)


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"] and BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check with 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s a cell, 1200 s spare.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(REPO, c["file"])) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}" and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_has_its_files_and_metrics(cell):
    wl = cells.workload(BENCH, cell)
    traffic = cells.traffic(wl["traffic"])
    assert hasattr(cells.module("drivers", traffic["driver"]), "setup")
    assert cells.limits(cell)
    e2e = {m["name"] for m in cells.end_to_end(BENCH, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = cells.per_layer(BENCH, cell)
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in layer:
        assert callable(cells.module("metrics", m["name"]).read)


@pytest.mark.parametrize("kernel", ["fast_score", "orb_describe", "hamming_match"])
def test_roofline_files_name_the_program_entry(kernel):
    mod_name, fn = cells.module("roofline", kernel).ENTRY
    assert mod_name.startswith("droplet_visual_odometry_tpu_torch.") and fn


def test_dummy_cell_and_metric_found_by_name(tiny_root):
    """New files only (configuration, mix, limits, a metric's reader) and
    new entries: the harness runs the cell and reads the metric."""
    bench = cells.spec(tiny_root)
    root = os.path.join(tiny_root, "benchmark")
    assert cells.config(bench, "tiny_cam", tiny_root)["camera"]["width"] == 320
    assert cells.traffic("offline_t", root)["clip_frames"] == 16
    assert [m["name"] for m in cells.per_layer(bench, "tiny_cam.offline_t")] == ["tiny_calls.seq"]
    res = drive(tiny_root, run_cell_body("tiny_cam.offline_t", 2**31 + 5, 0.5, True))
    assert res["metrics"] == {"tiny_calls.seq": {"value": float(res["attempted"]), "unit": "calls"}}
    assert res["correct"] is True
