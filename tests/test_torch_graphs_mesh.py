"""The port's sharded programs as captured graphs (utils/graphs.py with a
mesh), checked on the CPU.

On the card, sharding.shard_pair_vo, pose_graph.optimize(mesh=) and
distributed_ba.run_ba_distributed replay one CUDA graph per signature and
mesh when the mesh's group runs on NCCL, their collectives inside; on gloo
and without a group they run op by op. A CPU cannot capture, so here: the
capture rule and the teardown with stand-in mesh records and a stand-in
capture; the cache's lockstep (the same calls over a mesh give the same
captures and evictions on every rank, whatever else a rank runs); and on 2
spawned gloo ranks
(tests/torch_mp_worker.py) each sharded body under test_torch_graphs's
HostGuard, each entry point equal to its eager twin bit for bit, and the
cache keys of plain, mesh and new-group calls. The entry points' agreement
with the JAX package's sharded runs is held, at their tolerances, by
test_torch_parallel.py, test_torch_parallel_pg.py and
test_torch_distributed_ba.py, which call the same entry points.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from droplet_visual_odometry_tpu_torch.backend import ba, pose_graph
from droplet_visual_odometry_tpu_torch.data import synthetic as tsynth
from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig
from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
from droplet_visual_odometry_tpu_torch.parallel import launch, sharding
from droplet_visual_odometry_tpu_torch.utils import graphs

from test_torch_graphs import ba_window, loop_graph
from torch_mp_worker import run_ranks

torch.set_num_threads(2)

CUDA0 = torch.device("cuda", 0)


def standin_mesh(backend, group=None, size=1, rank=0):
    """A Mesh record on cuda:0 with a stand-in group (a fresh object unless
    given; None for the group-less mesh)."""
    if group is None and backend is not None:
        group = object()
    return sharding.Mesh(group, size, rank, CUDA0, "frames", backend)


class StubGraph:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def replay(self):
        self.log.append(("replay", self.name))

    def reset(self):
        self.log.append(("reset", self.name))


@pytest.fixture
def stub_cache():
    """graphs with an empty cache and a stand-in capture; yields the event
    log: ("capture" | "replay" | "reset", name)."""
    log = []

    def fake_capture(name, body, inputs, device, mesh=None):
        log.append(("capture", name))
        return graphs.Program(name=name, graph=StubGraph(log, name), inputs=(), outputs=torch.zeros(2),
                              captured_launches={}, capture_s=0.0, memory_bytes=0, mesh=mesh)

    with mock.patch.object(graphs, "_capture", fake_capture), mock.patch.object(graphs, "_cache", {}):
        yield log


# --------------------------------------------------------------------------
# The capture rule, the keys and the teardown, with stand-in meshes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend,captured", [("nccl", True), ("gloo", False), (None, False)])
def test_capture_rule_follows_the_group_backend(stub_cache, backend, captured):
    """On a CUDA device an NCCL mesh captures (and the body never runs
    eagerly), a gloo mesh and a mesh without a group run the body op by op
    and cache nothing; no mesh captures; off CUDA nothing captures."""
    eager = []

    def body(*_):
        eager.append(1)
        return torch.ones(2)

    mesh = standin_mesh(backend)
    graphs.run("p", body, (None,), 0, CUDA0, mesh)
    assert (("capture", "p") in stub_cache) == captured and bool(eager) != captured
    assert len(graphs.programs()) == int(captured)
    graphs.run("plain", body, (None,), 0, CUDA0)
    assert ("capture", "plain") in stub_cache
    before = len(stub_cache)
    graphs.run("cpu", body, (None,), 0, "cpu", standin_mesh("nccl"))
    assert len(stub_cache) == before and len(eager) == 1 + int(not captured)


def test_keys_hold_the_mesh_identity():
    """The key holds (group, size, rank, backend): a mesh call never shares
    a key with the plain call, a new group (same size and rank) gives a new
    key, and an equal mesh record the same key."""
    x = (torch.zeros(3),)
    m = standin_mesh("nccl")
    plain = graphs._key("p", 0, x, CUDA0)
    keyed = graphs._key("p", 0, x, CUDA0, m)
    assert plain != keyed and plain[-1] is None and keyed[-1] == (m.group, 1, 0, "nccl")
    assert graphs._key("p", 0, x, CUDA0, standin_mesh("nccl")) != keyed
    assert graphs._key("p", 0, x, CUDA0, dataclasses.replace(m)) == keyed
    assert graphs._key("p", 0, x, CUDA0, dataclasses.replace(m, rank=1, size=2)) != keyed


def test_clear_mesh_drops_only_that_groups_programs(stub_cache):
    """clear(mesh=m) resets and drops the programs captured over m's group
    (any mesh record on it), keeping other groups' and plain programs."""
    m, n = standin_mesh("nccl"), standin_mesh("nccl")
    body = lambda *_: torch.ones(2)
    graphs.run("a", body, (None,), 0, CUDA0, m)
    graphs.run("b", body, (None,), 1, CUDA0, dataclasses.replace(m, axis_name="edges"))
    graphs.run("c", body, (None,), 0, CUDA0, n)
    graphs.run("d", body, (None,), 0, CUDA0)
    graphs.clear(mesh=m)
    assert [p.name for p in graphs.programs()] == ["c", "d"]
    assert [e for e in stub_cache if e[0] == "reset"] == [("reset", "a"), ("reset", "b")]


def test_shutdown_drops_collective_programs_before_destroying_the_group(stub_cache):
    """launch.shutdown: every program over a group is dropped (reset) first,
    then the process group is destroyed; plain programs stay."""
    body = lambda *_: torch.ones(2)
    graphs.run("a", body, (None,), 0, CUDA0, standin_mesh("nccl"))
    graphs.run("b", body, (None,), 0, CUDA0, standin_mesh("nccl"))
    graphs.run("plain", body, (None,), 0, CUDA0)
    destroy = lambda: stub_cache.append(("destroy",))
    with mock.patch.object(launch.dist, "is_initialized", return_value=True), \
            mock.patch.object(launch.dist, "destroy_process_group", side_effect=destroy):
        launch.shutdown()
    assert sorted(stub_cache[-3:-1]) == [("reset", "a"), ("reset", "b")] and stub_cache[-1] == ("destroy",)
    assert [p.name for p in graphs.programs()] == ["plain"]


def test_cache_is_in_lockstep_over_a_mesh():
    """Two ranks' caches (each fresh, the same stand-in capture) driven by
    the same calls over a mesh (more signatures than CAPACITY, repeats)
    capture, replay and evict the mesh's programs at the same calls, though
    rank 0 also runs one-device programs and a sub-mesh of its own in
    between: a mesh's programs live in their own LRU, so its captures and
    evictions follow only the calls over that mesh."""
    mesh_calls = [0, 1, 2, 0, 3, 4, 5, 6, 1, 7, 2, 0, 8]

    def rank_log(rank):
        log = []
        mesh = standin_mesh("nccl", group="world", size=2, rank=rank)
        own = standin_mesh("nccl", group="rank 0 alone")

        def fake_capture(name, body, inputs, device, mesh=None):
            log.append(("capture", name))
            return graphs.Program(name=name, graph=StubGraph(log, name), inputs=(), outputs=None,
                                  captured_launches={}, capture_s=0.0, memory_bytes=0, mesh=mesh)

        with mock.patch.object(graphs, "_capture", fake_capture), mock.patch.object(graphs, "_cache", {}):
            for step, i in enumerate(mesh_calls):
                graphs.run(f"m{i}", None, (torch.zeros(i + 1),), 0, CUDA0, mesh)
                if rank == 0:  # calls the other rank does not make
                    graphs.run(f"p{step}", None, (torch.zeros(1),), 0, CUDA0)
                    graphs.run(f"s{step % 3}", None, (torch.zeros(step + 1),), 0, CUDA0, own)
            graphs.clear(mesh=mesh)
        return log

    a, b = rank_log(0), rank_log(1)
    on_mesh = lambda log: [e for e in log if e[1].startswith("m")]
    assert on_mesh(a) == on_mesh(b) and a != b
    mesh_events = on_mesh(a)
    assert sum(e[0] == "capture" for e in mesh_events) == 9 + 3  # 9 signatures; 3 captured again after eviction
    assert sum(e[0] == "reset" for e in mesh_events) == 12  # 6 evictions (12 captures, 6 slots), then the clear
    assert sum(e[0] == "replay" for e in mesh_events) == len(mesh_calls)


# --------------------------------------------------------------------------
# The sharded programs on 2 gloo ranks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair_args():
    """8 pairs of 256x192 frames, K = 128, 64/16 hypotheses."""
    seq = tsynth.render_sequence(tsynth.SyntheticConfig(n_frames=9, width=256, height=192, n_landmarks=300))
    cfg = VOConfig(n_keypoints=128, ransac=RansacConfig(n_hypotheses=64, lo_hypotheses=16))
    frames = torch.from_numpy(seq.frames).float()
    corners = torch.from_numpy(np.nan_to_num(seq.marker_corners).astype(np.float32))
    mvalid = torch.from_numpy(seq.marker_present[:-1] & seq.marker_present[1:])
    K = torch.from_numpy(seq.camera.K.astype(np.float32))
    return frames[:-1], frames[1:], corners[:-1], corners[1:], mvalid, K, seq.real_marker_length, cfg


@pytest.fixture(scope="module")
def ranks(pair_args, tmp_path_factory):
    inputs = {"gm_pair_vo_args": pair_args,
              "gm_graph": (loop_graph(), pose_graph.PoseGraphConfig(iters=3, cg_iters=20)),
              "gm_window": (ba_window(4, 41), ba.BAConfig(iters=3, n_fixed=2))}
    return run_ranks(tmp_path_factory.mktemp("graphs_mesh"), ["graphs_mesh"], inputs)


def _equal_dicts(a, b):
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_gloo_mesh_runs_op_by_op_and_caches_nothing(ranks):
    for r in ranks:
        assert r["gm_backend"] == "gloo" and r["gm_programs_cached"] == 0


def test_sharded_bodies_have_no_host_read(ranks):
    """Each body ran twice, the second under HostGuard (no host read, no
    host data, no data-dependent shape), with its collectives on both
    ranks, and gave the entry point's result."""
    for r in ranks:
        torch.testing.assert_close(r["gm_pair_vo_guarded"], r["gm_shard_pair_vo"], rtol=0, atol=0)
        poses, cost, live = r["gm_gn_step_guarded"]
        assert poses.shape == (16, 4, 4) and bool(torch.isfinite(poses).all()) and bool(torch.isfinite(cost))
        assert live.dtype == torch.int32 and 0 <= int(live) <= 100
        _equal_dicts(r["gm_ba_guarded"], r["gm_ba"])


def test_sharded_entry_points_equal_their_eager_twins(ranks, pair_args):
    """shard_pair_vo, optimize(mesh=) and run_ba_distributed equal their
    _eager twins bit for bit on each rank, and the ranks agree; the 8 rels
    equal pair_vo_batched's and pair_vo_batched_eager's on one device."""
    for r in ranks:
        torch.testing.assert_close(r["gm_shard_pair_vo"], r["gm_shard_pair_vo_eager"], rtol=0, atol=0)
        _equal_dicts(r["gm_optimize"], r["gm_optimize_eager"])
        _equal_dicts(r["gm_ba"], r["gm_ba_eager"])
        assert float(r["gm_optimize"]["final_cost"]) < float(r["gm_optimize"]["initial_cost"])
        assert float(r["gm_ba"]["final_cost"]) < float(r["gm_ba"]["initial_cost"])
        assert r["gm_ba"]["points"].shape == (42, 3)  # 41 landmarks padded to 2 x 21
    for key in ("gm_shard_pair_vo", "gm_optimize", "gm_ba"):
        a, b = ranks[0][key], ranks[1][key]
        _equal_dicts(a, b) if isinstance(a, dict) else torch.testing.assert_close(a, b, rtol=0, atol=0)
    plain = sharding.pair_vo_batched(*pair_args, seed=4, device="cpu")
    torch.testing.assert_close(plain, sharding.pair_vo_batched_eager(*pair_args, seed=4, device="cpu"), rtol=0, atol=0)
    torch.testing.assert_close(ranks[0]["gm_shard_pair_vo"], plain, rtol=0, atol=0)


def test_sharded_keys_hold_the_mesh(ranks):
    """Through the entry points on a real gloo group: one key a call
    (optimize's GN steps share theirs), the mesh call's key holds the
    group, never a plain call's key, the same mesh gives the same key and
    a new group a new one."""
    for r in ranks:
        assert set(r["gm_keys_per_call"].values()) == {1}
        assert r["gm_key_checks"] == dict.fromkeys(r["gm_key_checks"], True)
        assert len(r["gm_key_checks"]) == 5
