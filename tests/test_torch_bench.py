"""The port's bench harness (droplet_visual_odometry_tpu_torch/bench.py)
against the repository's bench.py (CPU).

Each measure runs through the module's functions on a small sequence (4
frames of 320x240, device="cpu") and returns bench.py's JSON keys (the card's
name and power limit in place of bench.py's TPU probe flag); the copied
OpenCV baseline holds its source equal to bench.py's, function by function;
the default device "cuda" raises here, where there is no GPU. bench.py
itself is read as text, never imported.
"""

import ast
import inspect
import json
import os

import numpy as np
import pytest
import torch

from droplet_visual_odometry_tpu_torch import bench

torch.set_num_threads(2)

BENCH_PY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench.py")
SMALL = dict(n_frames=4, width=320, height=240)


def _reference_tree():
    with open(BENCH_PY) as f:
        text = f.read()
    return text, ast.parse(text)


def _reference_keys(function: str) -> set[str]:
    """The keys of the dict literal bench.py's `function` prints with json.dumps."""
    _, tree = _reference_tree()
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == function)
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps":
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"no json.dumps in bench.py:{function}")


def _port_keys(reference_function: str) -> set[str]:
    """bench.py's keys with its TPU probe flag replaced by the card's name and power limit."""
    return (_reference_keys(reference_function) - {"device_probe_ok"}) | {"device", "power_limit"}


@pytest.fixture(scope="module")
def seq():
    return bench.build_sequence(**SMALL)


def _check_cpu_line(out: dict, reference_function: str) -> None:
    assert set(out) == _port_keys(reference_function)
    assert (out["backend"], out["device"], out["power_limit"]) == ("cpu", "cpu", None)
    json.loads(json.dumps(out))
    assert np.isfinite(out["value"]) and out["value"] > 0


def test_headline_on_cpu(seq):
    """The default mode's line: ours (run_sequence, seed 0's draws) against
    the live OpenCV baseline, with bench.py's keys."""
    out = bench.bench_headline(seq, device="cpu")
    _check_cpu_line(out, "main")
    assert out["metric"] == "vo_frames_per_second_320x240" and out["unit"] == "frames/s"
    assert out["vs_baseline"] == out["value"] / out["baseline_reference_cpu_fps"]


def test_online_on_cpu(seq):
    """--online: OnlineVO pushes timed with device-resident and host frames
    (here both on the CPU), median and p99 each, bench.py's keys."""
    out = bench.bench_online(seq, device="cpu")
    _check_cpu_line(out, "bench_online")
    assert out["n_pushes_each"] == bench.ONLINE_ROUNDS * (2 * len(seq) - 2)
    for regime in ("device_resident", "host_ingest"):
        r = out[regime]
        assert set(r) == {"median_ms", "p99_ms", "fps"} and 0 < r["median_ms"] <= r["p99_ms"]


def test_stages_on_cpu(seq):
    """--stages: each stage of run_sequence timed alone, in ms per frame."""
    out = bench.bench_stages(seq, device="cpu")
    assert set(out) == {"resize(pyramid)", "fast_score", "nms+topk", "blur", "describe", "match", "ransac"}
    assert all(np.isfinite(v) and v > 0 for v in out.values())


@pytest.mark.parametrize("source", ["vostore_host_stream", "device_resident_tiles"])
def test_stream_on_cpu(seq, source, tmp_path, monkeypatch):
    """--stream: 11 frames of the sequence in ping-pong through
    run_sequence_checkpointed in chunks of 4, from a VOSTORE1 file the
    harness writes (then holds 11 frames) or gathered on the device."""
    monkeypatch.setattr(bench, "STREAM_CHUNK", 4)
    store = str(tmp_path / "stream.vost") if source == "vostore_host_stream" else None
    out = bench.bench_stream(seq, store=store, n_total=11, device="cpu")
    _check_cpu_line(out, "bench_stream")
    assert out["source"] == source and out["metric"] == "stream_vo_frames_per_second_11x320x240"
    assert 0 <= out["ok_fraction"] <= 1
    if store is not None:
        from droplet_visual_odometry_tpu_torch.data import native_store

        with native_store.StoreReader(store) as reader:
            idx = [0, 1, 2, 3, 2, 1, 0, 1, 2, 3, 2]
            np.testing.assert_array_equal(reader.read(0, 11), seq.frames[idx])


@pytest.mark.parametrize("name", ["bench_reference_cpu", "_reference_cpu_pass"])
def test_copied_baseline_equals_bench_py(name):
    """The live baseline is bench.py's, copied: the function's source and the
    repetition count equal, so vs_baseline means what it means there."""
    text, tree = _reference_tree()
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    want = ast.get_source_segment(text, fn).replace("droplet_visual_odometry_tpu.", "droplet_visual_odometry_tpu_torch.")
    assert inspect.getsource(getattr(bench, name)).rstrip() == want.rstrip()
    reps = next(n for n in tree.body if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == "N_BASELINE_REPS")
    assert bench.N_BASELINE_REPS == ast.literal_eval(reps.value)


@pytest.mark.parametrize("argv", [[], ["--stages"], ["--online"], ["--stream"]])
def test_default_device_raises_without_gpu(argv):
    """Every mode runs on the card by default: without one it raises before
    any work, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(argv)
    for fn in (bench.bench_ours, bench.bench_online, bench.bench_stream, bench.bench_headline):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
