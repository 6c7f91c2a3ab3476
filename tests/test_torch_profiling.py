"""The port's recorder (droplet_visual_odometry_tpu_torch/utils/profiling.py)
and the spans and counts of the shipped path.

On the CPU: span nesting, parents and roots, the ring's bound, DVO_TRACE=0,
snapshot's window, counts on device tensors, the stage bookkeeping of
replayed programs (with stand-in events), the Chrome trace's recorder rows,
and run_experiment's span tree for backend "none", "pose_graph" and
streamed VO on a tiny clip, with the PCG's live iterations against a plain
while loop and loop.verify's counts against what find_loop_closures used.

On the card (marker `cuda`, skipped here; run them there with
`python -m pytest tests/test_torch_profiling.py -m cuda -q --noconftest -o addopts= -p no:cacheprovider`):
the VO replay's in-graph stages resolve and sum to the replay's device
span; the recorder adds no synchronising call and no device activity.
This file imports no jax.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

from droplet_visual_odometry_tpu_torch import pipeline
from droplet_visual_odometry_tpu_torch.backend import keyframes, loop_closure, pose_graph, refine
from droplet_visual_odometry_tpu_torch.core import se3
from droplet_visual_odometry_tpu_torch.data.synthetic import SyntheticConfig, render_sequence
from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig
from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
from droplet_visual_odometry_tpu_torch.ops import cuda_pcg
from droplet_visual_odometry_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A tiny marker-gap loop and budgets under which the pose-graph path runs
# whole (keyframes, retrieval, a bridge pair verified, edges, GN) in seconds.
CLIP = dict(n_frames=24, width=320, height=240, n_landmarks=300, orbit_sweep=0.6, dolly=0.5, loop=True,
            noise_std=1.5)
KEEP = 5
VO_CFG = VOConfig(scale_mode="hold", ransac=RansacConfig(n_hypotheses=64, lo_hypotheses=16))
PG_CFG = refine.PoseGraphRefineConfig(
    kf=keyframes.KeyframeConfig(max_gap=2),
    lc=loop_closure.LoopClosureConfig(min_gap=5, min_inliers=30, max_candidates=4, verify_hypotheses=64,
                                      verify_lo_hypotheses=16, verify_restarts=2),
    n_keypoints=256,
)
SEQUENCE_SPANS = {"pipeline.camera", "vo.run", "pipeline.anchor", "pipeline.metrics", "pipeline.tum"}
BACKEND_SPANS = {"refine.keyframes", "refine.fetch", "refine.features", "loop.retrieval", "loop.select",
                 "loop.verify", "loop.pick", "refine.graph", "pg.optimize", "refine.reanchor"}


def tiny_loop(width=CLIP["width"], height=CLIP["height"], n_frames=CLIP["n_frames"]):
    seq = render_sequence(SyntheticConfig(**dict(CLIP, width=width, height=height, n_frames=n_frames)))
    present, corners = seq.marker_present.copy(), seq.marker_corners.copy()
    present[KEEP:-KEEP] = False
    corners[KEEP:-KEEP] = np.nan
    return dataclasses.replace(seq, marker_present=present, marker_corners=corners)


@pytest.fixture(scope="module")
def seq():
    return tiny_loop()


def tree(records):
    """name -> records, and seq -> children."""
    kids = {}
    for r in records:
        kids.setdefault(r.parent, []).append(r)
    return kids


# -- the recorder ---------------------------------------------------------------

def test_spans_nest_with_parents_and_roots():
    rec = profiling.Recorder(capacity=64)
    with rec.span("a", k=1) as a:
        with rec.span("b") as b:
            with rec.span("c"):
                pass
        b.set(n=3)
    with rec.span("d") as d:
        pass
    out = {r.name: r for r in rec.snapshot()}
    assert [r.name for r in rec.snapshot()] == ["a", "b", "c", "d"]
    assert out["a"].parent == -1 and out["b"].parent == a.seq and out["c"].parent == b.seq
    assert out["a"].root == out["b"].root == out["c"].root == a.seq and out["d"].root == d.seq != a.seq
    assert out["a"].attrs == {"k": 1} and out["b"].attrs == {"n": 3}
    assert out["a"].t0 <= out["b"].t0 <= out["c"].t0 <= out["c"].t1 <= out["b"].t1 <= out["a"].t1
    assert out["a"].dev_t0 is None and out["a"].root_t0 == out["c"].root_t0 == out["a"].t0


def test_span_as_a_decorator_opens_one_span_per_call():
    rec = profiling.Recorder(capacity=64)

    @rec.span("f", kind="x")
    def f(v):
        with rec.span("g"):
            return v + 1

    assert f(1) == 2 and f(2) == 3 and f.__name__ == "f"
    out = rec.snapshot()
    assert [r.name for r in out] == ["f", "g", "f", "g"]
    assert out[1].parent == out[0].seq and out[3].parent == out[2].seq and out[0].root != out[2].root
    assert out[0].attrs == out[2].attrs == {"kind": "x"} and out[0].attrs is not out[2].attrs


def test_ring_keeps_the_newest_records():
    rec = profiling.Recorder(capacity=4)
    for i in range(10):
        with rec.span(f"s{i}"):
            pass
    assert [r.name for r in rec.snapshot()] == ["s6", "s7", "s8", "s9"]
    assert len(rec._ring) == 4 and profiling.RING >= 8192


def test_snapshot_keeps_the_roots_opened_in_its_window():
    rec = profiling.Recorder(capacity=64)
    with rec.span("early"):
        pass
    t0 = time.perf_counter()
    with rec.span("inside"):
        with rec.span("child"):
            pass
    t1 = time.perf_counter()
    with rec.span("late"):
        pass
    with rec.span("open"):
        assert [r.name for r in rec.snapshot(t0, t1)] == ["inside", "child"]
        assert "open" not in [r.name for r in rec.snapshot()]  # still open
    assert [r.name for r in rec.snapshot(t1)] == ["late", "open"]


def test_counts_on_tensors_are_summed_when_read():
    rec = profiling.Recorder(capacity=8)
    with rec.span("s") as s:
        s.set(live=torch.tensor(7, dtype=torch.int32), rows=torch.tensor([1.5, 2.0]), host=3)
    (r,) = rec.snapshot()
    assert r.attrs == {"live": 7, "rows": 3.5, "host": 3} and isinstance(r.attrs["live"], int)


def test_dvo_trace_0_records_nothing():
    """Read at import: every span is the shared no-op, as context manager,
    record and decorator, and nothing reaches the ring."""
    code = """
import json
from droplet_visual_odometry_tpu_torch.utils import profiling
f = lambda: 1
with profiling.span("a", device="cpu") as s:
    s.set(n=1)
    with profiling.device_stage("st"):
        pass
print(json.dumps(dict(enabled=profiling.ENABLED, noop=s is profiling.NOOP, same=profiling.span("b") is profiling.NOOP,
                      deco=profiling.span("c")(f) is f, records=len(profiling.snapshot()))))
"""
    env = dict(os.environ, DVO_TRACE="0", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == dict(enabled=False, noop=True, same=True, deco=True,
                                                                   records=0)
    assert profiling.ENABLED and profiling.span("x") is not profiling.NOOP


class FakeEvent:
    """A CUDA event's stand-in: done or not, at a time in ms."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_replayed_stages_resolve_or_count_as_unresolved():
    """A replay's stages become child records once their events are done;
    a replay whose stages the next replay of the graph overwrites first is
    counted on its span and gives no stage record."""
    rec = profiling.Recorder(capacity=64)
    rec._anchor = (FakeEvent(0.0), 100.0)
    stages = [profiling._Stage("vo.frontend", {"frames": 4}, FakeEvent(1.0, False), FakeEvent(3.0, False)),
              profiling._Stage("vo.solver", {"frames": 4}, FakeEvent(3.0, False), FakeEvent(4.0, False))]
    with rec.span("root"):
        with rec.span("graphs.replay") as first:
            pass
        rec.replayed(first, stages)
        rec.resolve()  # still running: stays pending
        with rec.span("graphs.replay") as second:
            pass
        rec.replayed(second, stages)  # the first's events are overwritten
        for s in stages:
            s.start.done = s.end.done = True
        rec.resolve()
    out = rec.snapshot()
    names = [r.name for r in out]
    assert names.count("vo.frontend") == names.count("vo.solver") == 1
    by_name = {r.name: r for r in out if r.name.startswith("vo.")}
    assert by_name["vo.frontend"].parent == by_name["vo.solver"].parent == second.seq
    assert by_name["vo.frontend"].dev_t0 == pytest.approx(100.001) and by_name["vo.solver"].dev_t1 == pytest.approx(100.004)
    assert by_name["vo.frontend"].attrs == {"frames": 4}
    assert next(r for r in out if r.seq == first.seq).attrs == {"stages_unresolved": 1}
    assert "stages_unresolved" not in next(r for r in out if r.seq == second.seq).attrs


def test_device_stage_is_a_no_op_outside_a_capture():
    with profiling.RECORDER.collect_stages() as stages:
        with profiling.device_stage("vo.frontend", frames=2):
            x = torch.ones(3) * 2
    assert stages == [] and torch.equal(x, torch.full((3,), 2.0))


def test_trace_carries_the_recorders_spans(tmp_path):
    """--profile-dir's exporter: the recorder's spans of the block are
    complete events in the Chrome trace, on the profiler's clock (after
    the anchor range, inside the block's profiler ops)."""
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("test.outer", n=2):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "recorder"]
    assert [e["name"] for e in ours] == ["test.outer"] and ours[0]["args"]["n"] == 2
    anchor = next(e for e in events if e.get("name") == profiling._ANCHOR_NAME)
    mm = next(e for e in events if "mm" in e.get("name", "") and e.get("ph") == "X")
    assert anchor["ts"] <= ours[0]["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= ours[0]["ts"] + ours[0]["dur"] + 50


# -- the shipped path's spans ------------------------------------------------------

@pytest.mark.parametrize("backend,stream", [("none", False), ("pose_graph", False), ("pose_graph", True)])
def test_run_experiment_records_its_span_tree(seq, tmp_path, monkeypatch, backend, stream):
    block = 5  # keyframes a staging block of the streamed fetch holds
    monkeypatch.setattr(pipeline, "FETCH_BLOCK_BYTES", block * CLIP["width"] * CLIP["height"])
    t0 = time.perf_counter()
    res = pipeline.run_experiment(seq, VO_CFG, out_dir=str(tmp_path), backend=backend,
                                  refine_cfg=PG_CFG if backend == "pose_graph" else None, stream=stream,
                                  checkpoint_chunk=10, device="cpu")
    out = profiling.snapshot(t0)
    roots = [r for r in out if r.parent == -1]
    assert [r.name for r in roots] == ["pipeline.run_experiment"]
    root = roots[0]
    assert all(r.root == root.seq for r in out)
    kids = tree(out)
    top = {r.name for r in kids[root.seq]}
    want = SEQUENCE_SPANS | ({"refine.pose_graph"} if backend == "pose_graph" else set())
    assert top == want | ({"pipeline.preprocess", "vo.fetch"} if not stream else set())
    covered = sum(r.t1 - r.t0 for r in kids[root.seq])
    assert covered >= 0.9 * (root.t1 - root.t0)

    traj = res.trajectory
    pairs = len(seq) - 1
    assert root.attrs == dict(backend=backend, frames=len(seq), pairs=pairs,
                              hypotheses=pairs * VO_CFG.ransac.n_hypotheses,
                              matches=int(np.sum(traj.n_matches)), inliers=int(np.sum(traj.n_inliers)))
    vo_run = next(r for r in kids[root.seq] if r.name == "vo.run")
    if stream:
        chunks = kids[vo_run.seq]
        assert [c.name for c in chunks] == ["checkpoint.chunk"] * 3
        assert [c.attrs["pairs"] for c in chunks] == [10, 10, 3]
        for c in chunks:
            assert [k.name for k in kids[c.seq]] == ["checkpoint.fill", "checkpoint.copy", "checkpoint.fetch"]
    if backend == "pose_graph":
        pg = next(r for r in kids[root.seq] if r.name == "refine.pose_graph")
        assert {r.name for r in kids[pg.seq]} == BACKEND_SPANS
        assert res.backend_info["n_loop_edges"] > 0
        fetch = next(r for r in kids[pg.seq] if r.name == "refine.fetch")
        n_kf = next(r for r in kids[pg.seq] if r.name == "refine.keyframes").attrs["keyframes"]
        n_blocks = -(-n_kf // block)
        if stream:  # a gather and an upload per staging block
            assert n_blocks > 1 and fetch.attrs == dict(frames=n_kf, blocks=n_blocks, pinned=0)
            assert [r.name for r in kids[fetch.seq]] == ["refine.gather", "refine.upload"] * n_blocks
            gathers = [r.attrs["frames"] for r in kids[fetch.seq] if r.name == "refine.gather"]
            assert sum(gathers) == n_kf and max(gathers) == block
        else:
            assert fetch.seq not in kids and fetch.attrs == {}
        steps = kids[next(r for r in kids[pg.seq] if r.name == "pg.optimize").seq]
        assert [r.name for r in steps] == ["pg.step"] * PG_CFG.pg.iters
        assert all(0 < r.attrs["live_iters"] <= PG_CFG.pg.cg_iters for r in steps)
        verify = next(r for r in kids[pg.seq] if r.name == "loop.verify")
        assert verify.attrs["accepted"] == res.backend_info["n_loop_edges"]


def _pcg_while(matvec, b, Minv, iters, tol, counts):
    """The reference's CG loop with a host stop test (k < iters and |r|^2 >
    tol |b|^2); appends its iteration count to `counts`."""
    apply_minv = lambda r: torch.einsum("mab,mb->ma", Minv, r)
    x, r = torch.zeros_like(b), b
    z = apply_minv(r)
    p = z
    stop = tol * torch.clamp(torch.sum(b * b), min=1e-30)
    k = 0
    while k < iters and bool(torch.sum(r * r) > stop):
        Hp = matvec(p)
        rz = torch.sum(r * z)
        alpha = rz / torch.clamp(torch.sum(p * Hp), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        z_new = apply_minv(r)
        beta = torch.sum(r * z_new) / torch.clamp(rz, min=1e-30)
        p = z_new + beta * p
        z = z_new
        k += 1
    counts.append(k)
    return x, torch.tensor(k, dtype=torch.int32)


def test_pcg_live_iters_equal_a_plain_while_loop():
    """optimize's pg.step spans carry, per GN step, the CG iterations the
    reference's while loop runs on the same system."""
    rng = np.random.default_rng(3)
    M = 14
    ang = np.linspace(0, 2 * np.pi, M, endpoint=False)
    xi = np.zeros((M, 6), np.float32)
    xi[:, 0], xi[:, 1], xi[:, 5] = 2 * np.cos(ang), 2 * np.sin(ang), ang
    truth = se3.se3_exp(torch.as_tensor(xi))
    noisy = se3.se3_exp(torch.as_tensor(rng.normal(0, 0.05, (M, 6)), dtype=torch.float32)) @ truth
    graph = pose_graph.sequential_edges(truth)._replace(poses=noisy)
    graph = pose_graph.add_edges(graph, [0, 3], [M - 1, 9], se3.inverse(truth[[0, 3]]) @ truth[[M - 1, 9]],
                                 torch.tensor([2.0, 2.0]))
    cfg = pose_graph.PoseGraphConfig(iters=4, cg_iters=100, cg_tol=1e-10)
    t0 = time.perf_counter()
    with profiling.span("test.root"):
        out = pose_graph.optimize(graph, cfg)
    live = [r.attrs["live_iters"] for r in profiling.snapshot(t0) if r.name == "pg.step"]
    counts: list[int] = []
    with mock.patch.object(cuda_pcg, "pcg", lambda *a: _pcg_while(*a, counts=counts)):
        ref = pose_graph.optimize_eager(graph, cfg)
    assert live == counts and len(live) == cfg.iters and all(0 < k < cfg.cg_iters for k in live)
    assert torch.equal(out.poses, ref.poses)


def test_pg_step_counts_the_cg_path():
    """Each pg.step span carries pcg_kernel: 0 where the CG ran op by op,
    as it does on the CPU (the kernel runs only on a CUDA device), for the
    PCG and the dense solver alike."""
    M = 10
    poses = se3.se3_exp(torch.as_tensor(np.random.default_rng(5).normal(0, 0.3, (M, 6)), dtype=torch.float32))
    graph = pose_graph.sequential_edges(poses)
    graph = graph._replace(poses=se3.se3_exp(0.01 * torch.ones(M, 6)) @ poses)
    for solver in ("pcg", "dense"):
        cfg = pose_graph.PoseGraphConfig(iters=2, solver=solver)
        t0 = time.perf_counter()
        with profiling.span("test.root"):
            pose_graph.optimize(graph, cfg)
        steps = [r for r in profiling.snapshot(t0) if r.name == "pg.step"]
        assert len(steps) == cfg.iters and all(r.attrs["pcg_kernel"] == 0 for r in steps), solver


def test_loop_verify_counts_what_find_loop_closures_used(seq):
    """loop.verify's candidates and slots are the pairs and (restart, slot)
    layout verification ran, accepted the edges it returned."""
    used = []
    layout = loop_closure._restart_layout

    def spy(ca, cb, n_slot, R):
        used.append((len(ca), n_slot, R))
        return layout(ca, cb, n_slot, R)

    t0 = time.perf_counter()
    with mock.patch.object(loop_closure, "_restart_layout", spy):
        res = pipeline.run_experiment(seq, VO_CFG, backend="pose_graph", refine_cfg=PG_CFG, device="cpu")
    (verify,) = [r for r in profiling.snapshot(t0) if r.name == "loop.verify"]
    ((n_c, n_slot, R),) = used
    assert verify.attrs == dict(candidates=n_c, slots=R * n_slot, accepted=res.backend_info["n_loop_edges"])
    assert R == PG_CFG.lc.verify_restarts and n_slot == loop_closure.verify_slots(n_c, PG_CFG.lc)


# -- on the card ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: in-graph timing events and device intervals exist on the card only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_vo_stages_resolve_and_sum_to_the_replay(cuda_device):
    """Each warm run_sequence replay's vo.frontend and vo.solver resolve,
    and their device times sum to the replay's device span within 10%."""
    clip = tiny_loop(width=640, height=480, n_frames=48)
    pipeline.run_experiment(clip, VO_CFG, device=cuda_device)  # captures, takes the anchor
    t0 = time.perf_counter()
    for _ in range(3):
        pipeline.run_experiment(clip, VO_CFG, device=cuda_device)
    out = profiling.snapshot(t0)
    replays = [r for r in out if r.name == "graphs.replay" and r.attrs["program"] == "run_sequence"]
    assert len(replays) == 3
    kids = tree(out)
    for rp in replays:
        assert "stages_unresolved" not in rp.attrs
        stages = {r.name: r for r in kids[rp.seq]}
        assert set(stages) == {"vo.frontend", "vo.solver"} and stages["vo.frontend"].attrs == {"frames": 48}
        fe, so = stages["vo.frontend"], stages["vo.solver"]
        assert rp.dev_t0 <= fe.dev_t0 <= fe.dev_t1 <= so.dev_t0 <= so.dev_t1 <= rp.dev_t1
        span = rp.dev_t1 - rp.dev_t0
        assert abs((fe.dev_t1 - fe.dev_t0) + (so.dev_t1 - so.dev_t0) - span) <= 0.1 * span


CARD_RUN = """
import collections, json, warnings
import torch
sys_path = __import__("sys").path
sys_path.insert(0, {repo!r})
sys_path.insert(0, {tests!r})
from test_torch_profiling import PG_CFG, VO_CFG, tiny_loop
from droplet_visual_odometry_tpu_torch import pipeline
clip = tiny_loop(width=640, height=480, n_frames=32)
run = lambda: pipeline.run_experiment(clip, VO_CFG, backend="pose_graph", refine_cfg=PG_CFG, device="cuda")
run()
run()  # warm: every program captured, the anchor taken
torch.cuda.synchronize()
torch.cuda.set_sync_debug_mode("warn")
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    run()
torch.cuda.set_sync_debug_mode(0)
syncs = sum("synchroniz" in str(w.message) for w in caught)
prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
with prof:
    run()
    torch.cuda.synchronize()
cuda = torch.autograd.DeviceType.CUDA
names = collections.Counter(e.name() for e in prof.profiler.kineto_results.events() if e.device_type() == cuda)
print(json.dumps(dict(syncs=syncs, device_activity=names)))
"""


@pytest.mark.cuda
def test_recorder_adds_no_sync_and_no_device_activity(cuda_device):
    """The same warm run_experiment with the recorder on and with
    DVO_TRACE=0: as many synchronising calls under set_sync_debug_mode
    ("warn"), and the same device activity in a CUDA-only torch.profiler
    trace (the recorder's timing events are no activity of their own)."""
    got = {}
    for flag in ("1", "0"):
        code = CARD_RUN.format(repo=REPO, tests=os.path.join(REPO, "tests"))
        proc = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, DVO_TRACE=flag), capture_output=True,
                              text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        got[flag] = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["1"]["syncs"] == got["0"]["syncs"] > 0
    assert got["1"]["device_activity"] == got["0"]["device_activity"]
