"""Process bring-up and the scaling-efficiency harness — port of
droplet_visual_odometry_tpu/parallel/launch.py.

One process (rank) per device (parallel/__init__.py):

  * `initialize()` — torch.distributed bring-up from explicit arguments or
    torchrun's variables (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK): NCCL on cuda:{LOCAL_RANK} for "cuda", gloo for "cpu";
    idempotent, and a no-op for a single process without a coordinator.
  * `shutdown()` — its end: the captured programs that hold collectives are
    dropped, then the process group is destroyed.
  * `global_mesh()` — the mesh over every rank of the world.
  * `measure_scaling_pair_vo()`, `measure_scaling_ba()` — weak-scaling
    throughput of data-parallel pair VO and distributed Schur BA over
    sub-meshes of the world's first 1, 2, 4, 8 ranks, with the efficiency
    against the 1-device run (the reference's workloads and defaults).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from droplet_visual_odometry_tpu_torch.utils import graphs
from droplet_visual_odometry_tpu_torch.utils.device import resolve_device


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
    backend: str | None = None,
) -> bool:
    """Bring up torch.distributed. Returns True if a process group is up
    (this call's or an earlier one's), False for a single process without a
    coordinator (nothing to initialise).

    coordinator_address is "host:port" (a TCP store on rank 0) or an init
    URL such as "file:///path/store"; it and the counts default to
    torchrun's variables. A coordinator initialises even at one process.
    device "cuda" means cuda:{LOCAL_RANK} (or process_id modulo the card
    count without LOCAL_RANK); backend defaults to "nccl" on CUDA and
    "gloo" on the CPU, and "gloo" may be asked for with CUDA tensors (two
    ranks sharing one card). A failed NCCL init raises."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        if num_processes in (None, 1):
            return False
        raise ValueError(f"{num_processes} processes need a coordinator address")
    num_processes = 1 if num_processes is None else num_processes
    process_id = 0 if process_id is None else process_id

    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count())))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    init_method = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes, rank=process_id)
    return True


def shutdown() -> None:
    """Destroy this process's torch.distributed group (and its sub-groups),
    first dropping every captured program whose graph holds a collective on
    one of them (utils/graphs.clear): a replay or an eviction after the
    group is gone would touch a dead communicator. A no-op without a group."""
    if not dist.is_initialized():
        return
    for mesh in {p.mesh for p in graphs.programs() if p.mesh is not None}:
        graphs.clear(mesh=mesh)
    dist.destroy_process_group()


def global_mesh(axis_name: str = "frames", device="cuda"):
    """1-D mesh over every rank of the world."""
    from droplet_visual_odometry_tpu_torch.parallel import sharding

    return sharding.make_mesh(None, axis_name, device)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclasses.dataclass
class ScalePoint:
    n_devices: int
    seconds: float
    throughput: float  # work units / s (frames/s for pair VO)
    efficiency: float  # throughput / (n_devices * throughput_1dev)


def _time_reps(fn, reps: int, device: torch.device) -> float:
    """Mean wall of fn() over reps calls after one warm-up call,
    synchronised with the card when it runs there."""
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps


def _device_counts(device_counts: list[int] | None) -> list[int]:
    world = dist.get_world_size() if dist.is_initialized() else 1
    if device_counts is None:
        return [n for n in (1, 2, 4, 8) if n <= world]
    return list(device_counts)


def _points(timed: list[tuple[int, float, float]]) -> list[ScalePoint]:
    """ScalePoints from (n_devices, seconds, work units) of the runs made here."""
    out, base = [], None
    for n, dt, units in timed:
        tput = units / dt
        base = tput if base is None else base
        out.append(ScalePoint(n_devices=n, seconds=dt, throughput=tput, efficiency=tput / (n * base)))
    return out


def measure_scaling_pair_vo(
    device_counts: list[int] | None = None,
    pairs_per_device: int = 2,
    height: int = 96,
    width: int = 128,
    n_keypoints: int = 64,
    reps: int = 3,
    device="cuda",
) -> list[ScalePoint]:
    """Weak-scaling pair-VO throughput: each device owns `pairs_per_device`
    pairs; ideal scaling is throughput proportional to device count. Every
    rank calls it; a rank outside a sub-mesh skips that size, so the
    coordinator (rank 0, in every sub-mesh) holds every point."""
    from droplet_visual_odometry_tpu_torch.data import synthetic
    from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu_torch.parallel import sharding

    dev = sharding.rank_device(device)
    device_counts = _device_counts(device_counts)
    max_pairs = max(device_counts) * pairs_per_device
    seq = synthetic.render_sequence(
        synthetic.SyntheticConfig(n_frames=max_pairs + 1, width=width, height=height, n_landmarks=60)
    )
    frames = torch.as_tensor(seq.frames, device=dev).float()
    corners = torch.nan_to_num(torch.as_tensor(seq.marker_corners, device=dev))
    mvalid = torch.as_tensor(seq.marker_present, device=dev)
    cfg = VOConfig(n_keypoints=n_keypoints, ransac=RansacConfig(n_hypotheses=128, lo_hypotheses=32))

    timed = []
    for n in device_counts:
        mesh = sharding.make_mesh(n, device=dev)
        if not mesh.is_member:
            continue
        b = n * pairs_per_device

        def run():
            return sharding.shard_pair_vo(
                mesh, frames[:b], frames[1 : b + 1], corners[:b], corners[1 : b + 1],
                mvalid[:b] & mvalid[1 : b + 1], seq.camera.K, seq.real_marker_length, cfg,
            )

        timed.append((n, _time_reps(run, reps, dev), b))
    return _points(timed)


def measure_scaling_ba(
    device_counts: list[int] | None = None,
    landmarks_per_device: int = 256,
    n_poses: int = 6,
    iters: int = 5,
    reps: int = 3,
    device="cuda",
) -> list[ScalePoint]:
    """Weak-scaling distributed Schur BA: each device owns a fixed landmark
    shard; throughput unit is landmarks/s through the LM loop. Every rank
    draws the same windows from one seeded numpy generator."""
    from droplet_visual_odometry_tpu_torch.backend import ba
    from droplet_visual_odometry_tpu_torch.core import se3
    from droplet_visual_odometry_tpu_torch.parallel import distributed_ba, sharding

    dev = sharding.rank_device(device)
    device_counts = _device_counts(device_counts)
    rng = np.random.default_rng(0)
    K = torch.tensor([[200.0, 0, 64], [0, 200.0, 48], [0, 0, 1]], dtype=torch.float32, device=dev)
    poses = torch.stack(
        [se3.make_se3(torch.eye(3), torch.tensor([0.2 * w, 0.0, 0.0])) for w in range(n_poses)]
    ).to(dev)

    timed = []
    for n in device_counts:
        L = n * landmarks_per_device
        pts = rng.uniform([-1, -1, 3], [1, 1, 6], size=(L, 3)).astype(np.float32)
        _, uv = ba._project(poses, torch.from_numpy(pts).to(dev), K)
        noise = rng.normal(scale=0.02, size=pts.shape).astype(np.float32)
        window = ba.BAWindow(
            poses=poses, points=torch.from_numpy(pts + noise).to(dev), obs_uv=uv,
            obs_mask=torch.ones((n_poses, L), dtype=torch.bool, device=dev), K=K,
        )
        mesh = sharding.make_mesh(n, axis_name="landmarks", device=dev)
        if not mesh.is_member:
            continue
        cfg = ba.BAConfig(iters=iters)
        timed.append((n, _time_reps(lambda: distributed_ba.run_ba_distributed(mesh, window, cfg).poses, reps, dev), L))
    return _points(timed)


def format_report(name: str, points: list[ScalePoint]) -> str:
    rows = [f"scaling: {name} (weak scaling — ideal efficiency = 1.0)"]
    for p in points:
        rows.append(
            f"  {p.n_devices:3d} dev  {p.seconds*1e3:9.2f} ms"
            f"  {p.throughput:10.1f} units/s  eff={p.efficiency:.2f}"
        )
    return "\n".join(rows)
