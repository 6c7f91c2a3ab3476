"""The last line's schema, and the lines that compare its numbers."""

import json
import os
import subprocess
import sys

from harness_tiny import REPO, drive, run_cell_body


def test_last_line_schema(tiny_root):
    res = drive(tiny_root, run_cell_body("tiny_cam.live_t", 2**31 + 7, 1.0, False))
    lines, modules = res.pop("lines"), res.pop("modules")
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] == 5
    assert set(res["metrics"]) == {"push_p95_ms", "device_mem_gib", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == {"push_rot_gap_deg", "push_trans_gap_m", "push_chain_gap_m"}
    # The numbers compared are the last lines, each with its limit.
    tail = lines[-len(res["checks"]):]
    for line, (name, c) in zip(tail, res["checks"].items()):
        assert line.startswith(f"{name} {c['value']!r} limit {c['limit']!r}")
    assert modules == []


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, os.path.join(REPO, "benchmark", "run.py"), "--workload",
                           "bluerov_1440.offline", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    if proc.returncode == 0:  # a machine with a card: the run is the chip's to judge
        json.loads(proc.stdout.strip().splitlines()[-1])
        return
    assert proc.returncode == 2 and proc.stdout.strip() == ""


def test_checkout_without_the_program_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    code = ("import sys; sys.path.insert(0, 'benchmark'); import run\n"
            "try:\n    run.check_program()\nexcept run.RunRefused as e:\n    print('refused', e)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.stdout.startswith("refused"), proc.stdout + proc.stderr
