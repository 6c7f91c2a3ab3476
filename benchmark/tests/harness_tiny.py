"""A throwaway checkout holding the benchmark with tiny cells added as new
files only (a configuration, three traffic mixes, their limits and a
per-layer metric) and BENCHMARK.json extended, the port linked in; and a
way to drive the harness there on the CPU in a fresh process."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

TINY_CAMERA = dict(width=320, height=240, fx=262.0, fy=261.0, cx=166.0, cy=127.6,
                   distortion=[-0.296079, 0.099771, 0.000222, 0.000109, 0.0])
TINY_CELLS = {  # cell -> (traffic, the real mix it shrinks, its changes)
    "tiny_cam.offline_t": ("offline_t", "offline", dict(clip_frames=16, sequence_frames=16, marker_keep=4)),
    "tiny_cam.stream_t": ("stream_t", "stream", dict(clip_frames=16, sequence_frames=25, marker_keep=4, chunk=8)),
    "tiny_cam.live_t": ("live_t", "live", dict(clip_frames=16, rate_hz=5.0, sample_pushes=5)),
}
LIMITS_OF = {"offline_t": "bluerov_1440.offline", "stream_t": "bluerov_1440.stream", "live_t": "bluerov_1440.live"}
DUMMY_METRIC = '''"""tiny_calls.seq: the calls the traced window made (a test's reader)."""


def read(run):
    return float(len(run.window.calls))
'''


def make_checkout(root: str) -> str:
    """The benchmark copied under root with the tiny cells added; returns root."""
    shutil.copytree(BENCH, os.path.join(root, "benchmark"), ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "droplet_visual_odometry_tpu_torch"), os.path.join(root, "droplet_visual_odometry_tpu_torch"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "bluerov_1440.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny_cam", camera=TINY_CAMERA)
    _dump(os.path.join(b, "configs", "tiny_cam.json"), cfg)
    bench["configs"].append({"name": "tiny_cam", "source": "a test's camera", "file": "benchmark/configs/tiny_cam.json",
                             "reduced": [], "why": "a test"})
    for cell, (traffic, real, changes) in TINY_CELLS.items():
        with open(os.path.join(b, "traffic", f"{real}.json")) as f:
            t = json.load(f)
        t.update(changes)
        _dump(os.path.join(b, "traffic", f"{traffic}.json"), t)
        shutil.copy(os.path.join(b, "limits", f"{LIMITS_OF[traffic]}.json"), os.path.join(b, "limits", f"{cell}.json"))
        bench["workloads"].append({"name": cell, "config": "tiny_cam", "traffic": traffic, "chips": 1, "why": "a test"})
        moves = "push_p95_ms" if traffic == "live_t" else "seq_fps"
        if not any(m["name"] == moves for m in bench["end_to_end"]):  # the live mix's metric, out of BENCHMARK.json
            bench["end_to_end"].append({"name": moves, "unit": "ms", "better": "lower", "bound": 0.25,
                                        "source": "host_clock", "workloads": []})
        for m in bench["end_to_end"]:
            if m["name"] == moves:
                m["workloads"].append(cell)
    with open(os.path.join(b, "metrics", "tiny_calls.seq.py"), "w") as f:
        f.write(DUMMY_METRIC)
    bench["per_layer"].append({"name": "tiny_calls.seq", "unit": "calls", "better": "higher", "source": "host_clock",
                               "layer": "pipeline", "moves": "seq_fps", "workloads": ["tiny_cam.offline_t"]})
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root


def _dump(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


PRELUDE = """
import json, sys
sys.path.insert(0, {bench!r})
import run
"""


def drive(root: str, body: str, timeout: float = 900) -> dict:
    """Run `body` (Python, after `import run` from root's benchmark) in a
    fresh process; it prints one JSON line last, which is returned."""
    code = PRELUDE.format(bench=os.path.join(root, "benchmark")) + body
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=timeout,
                          env=env)
    if proc.returncode != 0:
        raise AssertionError(f"exit {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def run_cell_body(cell: str, seed: int, seconds: float, traced: bool, patch: str = "") -> str:
    """A body that applies `patch` (Python) and prints run_cell's result."""
    return patch + f"""
res, lines = run.run_cell({cell!r}, {seed}, {seconds}, {traced}, device="cpu", workers=2)
print(json.dumps(dict(res, lines=lines, modules=run.forbidden_modules())))
"""
