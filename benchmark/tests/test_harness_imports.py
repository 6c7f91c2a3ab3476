"""Nothing the benchmark runs imports JAX or the JAX package, or reads the
root bench.py, parity.py, tools/ or BENCH_*.json; the run's own check
compares whole top-level names."""

import ast
import os
import sys

from harness_tiny import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "droplet_visual_odometry_tpu"}


def _sources():
    for d, _, files in os.walk(BENCH):
        if os.path.basename(d) in ("tests", "__pycache__"):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.partition(".")[0] not in FORBIDDEN, (path, n)


def test_no_source_reads_the_jax_benchmarks():
    for path in _sources():
        with open(path) as f:
            text = f.read()
        for word in ("BENCH_r", "parity.py", "tools/", "MULTICHIP_", "SCALING_"):
            assert word not in text, (path, word)
        assert "open(" not in text or "bench.py" not in text, path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "droplet_visual_odometry_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "droplet_visual_odometry_tpu.pipeline", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["droplet_visual_odometry_tpu.pipeline", "jax.numpy"]


def test_a_run_loads_no_jax(tiny_root):
    from harness_tiny import drive, run_cell_body

    res = drive(tiny_root, run_cell_body("tiny_cam.live_t", 2**31 + 9, 0.5, False))
    assert res["modules"] == []
