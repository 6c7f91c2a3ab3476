"""Spawned gloo ranks for the port's multi-device tests (not collected).

The parent side, `run_ranks(tmp_path, cases, inputs)`, writes the inputs to
tmp_path, starts `world` copies of this file (one rank each, jax-free) and
returns each rank's outputs. A rank brings the group up through the port's
entry point, `parallel.launch.initialize`, with a FileStore in tmp_path (so
concurrent test workers cannot collide), runs each named case of CASES on
the CPU and saves its outputs. Every subprocess has its own timeout, so a
hung rendezvous fails the test instead of the suite.

    python torch_mp_worker.py <rank> <world> <tmp_dir> <case>[,<case>...]
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180


def run_ranks(tmp_path, cases: list[str], inputs: dict, world: int = 2) -> list[dict]:
    """Run `cases` in `world` spawned gloo ranks on `inputs`; each rank's outputs."""
    tmp = str(tmp_path)
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                                                               "LOCAL_RANK")}
    env["PYTHONPATH"] = os.pathsep.join([ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world), tmp, ",".join(cases)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, out, err) in enumerate(outs):
        if rc != 0:
            raise AssertionError(f"rank {r} exited {rc}\n{out[-2000:]}\n{err[-4000:]}")
    return [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False) for r in range(world)]


class FixedDraws:
    """A picklable draws(n) -> (u_hyp, u_lo) for loop_closure's
    verification that replays uniforms recorded for exactly n rows."""

    def __init__(self, u_hyp: torch.Tensor, u_lo: torch.Tensor):
        self.u_hyp, self.u_lo = u_hyp, u_lo

    def __call__(self, n: int):
        if n != len(self.u_hyp):
            raise ValueError(f"{n} rows of draws asked for, {len(self.u_hyp)} recorded")
        return self.u_hyp, self.u_lo


# --------------------------------------------------------------------------
# Cases: each takes the inputs dict and returns a dict of outputs.
# --------------------------------------------------------------------------


def case_pair_vo(inp: dict) -> dict:
    from droplet_visual_odometry_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(device="cpu")
    out = {"mesh": (mesh.size, mesh.rank, str(mesh.device), mesh.axis_name)}
    out["rels"] = sharding.shard_pair_vo(mesh, *inp["pair_vo_args"], u_hyp=inp["u_hyp"], u_lo=inp["u_lo"])
    # An odd batch does not divide over the two ranks.
    try:
        args = inp["pair_vo_args"]
        sharding.shard_pair_vo(mesh, *(a[:-1] for a in args[:5]), *args[5:])
        out["odd_batch"] = "no error"
    except ValueError as e:
        out["odd_batch"] = str(e)
    return out


def case_pcg(inp: dict) -> dict:
    from droplet_visual_odometry_tpu_torch.backend import pose_graph
    from droplet_visual_odometry_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(axis_name="edges", device="cpu")
    return {"pcg_" + name: pose_graph.optimize(graph, cfg, mesh=mesh)._asdict()
            for name, (graph, cfg) in inp["pcg_graphs"].items()}


def case_pg_trajectory(inp: dict) -> dict:
    from droplet_visual_odometry_tpu_torch.backend import refine

    out, info = refine.pose_graph_trajectory(*inp["pgt_args"], **inp["pgt_kwargs"])
    return {"pgt_poses": out, "pgt_info": info}


def case_ba(inp: dict) -> dict:
    from droplet_visual_odometry_tpu_torch.parallel import distributed_ba, sharding

    out = {}
    for name, (window, cfg) in inp["ba_windows"].items():
        res = distributed_ba.run_ba_distributed(sharding.make_mesh(axis_name="landmarks", device="cpu"), window, cfg)
        out["ba_" + name] = res._asdict()
    return out


def case_scaling(inp: dict) -> dict:
    from droplet_visual_odometry_tpu_torch.parallel import launch

    vo = launch.measure_scaling_pair_vo(device_counts=[1, 2], pairs_per_device=1, reps=1, device="cpu")
    ba = launch.measure_scaling_ba(device_counts=[1, 2], landmarks_per_device=32, n_poses=3, iters=2, reps=1,
                                   device="cpu")
    return {"scaling_pair_vo": [vars(p) for p in vo], "scaling_ba": [vars(p) for p in ba],
            "scaling_report": launch.format_report("pair_vo", vo), "is_coordinator": launch.is_coordinator()}


def case_graphs_mesh(inp: dict) -> dict:
    """The three sharded programs over this rank's gloo mesh: each body run
    under test_torch_graphs.HostGuard (after a warm-up), each entry point
    and its eager twin, the cache keys of plain, mesh and new-group calls,
    and no program cached (gloo runs op by op)."""
    import dataclasses
    import functools
    from unittest import mock

    import torch.distributed as dist

    from test_torch_graphs import guarded

    from droplet_visual_odometry_tpu_torch.backend import pose_graph
    from droplet_visual_odometry_tpu_torch.parallel import distributed_ba, sharding
    from droplet_visual_odometry_tpu_torch.utils import graphs

    mesh = sharding.make_mesh(device="cpu")
    args = inp["gm_pair_vo_args"]
    graph, pg_cfg = inp["gm_graph"]
    window, ba_cfg = inp["gm_window"]
    L, cfg = float(args[6]), args[7]
    out = {"gm_backend": mesh.backend}

    staged = sharding._shard_pair_vo_inputs(mesh, *args[:6], cfg, 4, None, None, None)
    body = functools.partial(sharding._pair_vo_body, cfg=cfg, real_marker_length=L, mesh=mesh)
    out["gm_pair_vo_guarded"] = guarded(body, *staged)
    out["gm_shard_pair_vo"] = sharding.shard_pair_vo(mesh, *args, seed=4)
    out["gm_shard_pair_vo_eager"] = sharding.shard_pair_vo_eager(mesh, *args, seed=4)

    def gn_step(poses, cur_cost, *tensors):
        return pose_graph._gn_step(pose_graph.PoseGraph(*tensors), poses, cur_cost, pg_cfg, mesh)

    out["gm_gn_step_guarded"] = guarded(gn_step, graph.poses, pose_graph.cost(graph), *graph)
    out["gm_optimize"] = pose_graph.optimize(graph, pg_cfg, mesh)._asdict()
    out["gm_optimize_eager"] = pose_graph.optimize_eager(graph, pg_cfg, mesh)._asdict()

    body = functools.partial(distributed_ba._ba_body, mesh=mesh, cfg=ba_cfg)
    out["gm_ba_guarded"] = guarded(body, *distributed_ba._shard_window(mesh, window))._asdict()
    out["gm_ba"] = distributed_ba.run_ba_distributed(mesh, window, ba_cfg)._asdict()
    out["gm_ba_eager"] = distributed_ba.run_ba_distributed_eager(mesh, window, ba_cfg)._asdict()

    # Keys: each call's key, recorded through graphs.run.
    keys, real = [], graphs.run

    def spy(name, body, inputs, static, device, mesh=None):
        keys[-1].add(graphs._key(name, static, inputs, torch.device(device), mesh))
        return real(name, body, inputs, static, device, mesh)

    other = dataclasses.replace(mesh, group=dist.new_group([0, 1]))
    half = slice(mesh.rank * (len(args[0]) // 2), (mesh.rank + 1) * (len(args[0]) // 2))
    calls = {
        "optimize": lambda: pose_graph.optimize(graph, pg_cfg),
        "optimize_mesh": lambda: pose_graph.optimize(graph, pg_cfg, mesh),
        "optimize_mesh_again": lambda: pose_graph.optimize(graph, pg_cfg, mesh),
        "optimize_new_group": lambda: pose_graph.optimize(graph, pg_cfg, other),
        "pair_vo_batched": lambda: sharding.pair_vo_batched(*(a[half] for a in args[:5]), *args[5:], device="cpu"),
        "shard_pair_vo": lambda: sharding.shard_pair_vo(mesh, *args),
        "shard_pair_vo_new_group": lambda: sharding.shard_pair_vo(other, *args),
        "ba_mesh": lambda: distributed_ba.run_ba_distributed(mesh, window, ba_cfg),
        "ba_new_group": lambda: distributed_ba.run_ba_distributed(other, window, ba_cfg),
    }
    with mock.patch.object(graphs, "run", spy):
        for name, call in calls.items():
            keys.append(set())
            call()
            out.setdefault("gm_keys_per_call", {})[name] = len(keys[-1])
    k = dict(zip(calls, keys))
    out["gm_key_checks"] = {
        "mesh_key_holds_the_group": all(key[-1] == (mesh.group, 2, mesh.rank, "gloo") for key in k["optimize_mesh"]),
        "plain_key_has_no_mesh": all(key[-1] is None for key in k["optimize"] | k["pair_vo_batched"]),
        "plain_and_mesh_differ": not (k["optimize"] & k["optimize_mesh"])
        and not (k["pair_vo_batched"] & k["shard_pair_vo"]),
        "same_mesh_same_key": k["optimize_mesh"] == k["optimize_mesh_again"],
        "new_group_new_key": not (k["optimize_mesh"] & k["optimize_new_group"])
        and not (k["shard_pair_vo"] & k["shard_pair_vo_new_group"]) and not (k["ba_mesh"] & k["ba_new_group"]),
    }
    out["gm_programs_cached"] = len(graphs.programs())
    return out


CASES = {"pair_vo": case_pair_vo, "pcg": case_pcg, "pg_trajectory": case_pg_trajectory, "ba": case_ba,
         "scaling": case_scaling, "graphs_mesh": case_graphs_mesh}


def main() -> int:
    rank, world, tmp, cases = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4].split(",")
    torch.set_num_threads(1)
    import torch.distributed as dist

    from droplet_visual_odometry_tpu_torch.parallel import launch

    if not launch.initialize(f"file://{os.path.join(tmp, 'store')}", world, rank, device="cpu"):
        raise AssertionError("initialize() did not bring up a process group")
    if (dist.get_backend(), dist.get_world_size(), dist.get_rank()) != ("gloo", world, rank):
        raise AssertionError(f"group {dist.get_backend()} world {dist.get_world_size()} rank {dist.get_rank()}")
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        out = {"rank": rank}
        for case in cases:
            out.update(CASES[case](inputs))
        torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
    finally:
        launch.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
