"""Multi-device sharding on torch.distributed: the mesh record, its
collectives, and data-parallel pair VO — port of
droplet_visual_odometry_tpu/parallel/sharding.py.

The reference shards with jax.sharding over a device mesh (the `frames`
axis for independent pairs, `landmarks` for distributed BA, `edges` for the
pose graph's product). Here one process drives one device (the process
model in parallel/__init__.py): every rank holds the full host copy of the
inputs, takes its block of the sharded axis, and the replicated results are
reduced (`psum`) or gathered (`all_gather_rows`) over the mesh's group.

All entry points take an explicit Mesh, so tests run them in spawned gloo
ranks on the CPU while the card runs them over NCCL.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig, two_frame_vo
from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch
from droplet_visual_odometry_tpu_torch.frontend.orb import Features
from droplet_visual_odometry_tpu_torch.utils import graphs, threefry
from droplet_visual_odometry_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks: the counterpart of a jax Mesh with one axis."""

    group: object  # torch.distributed process group; None without one (or outside it)
    size: int  # devices in the mesh (jax: mesh.devices.size)
    rank: int  # this process's rank in the group; -1 outside it
    device: torch.device  # this rank's device
    axis_name: str = "frames"
    backend: str | None = None  # the group's backend ("nccl", "gloo"); None without a group

    @property
    def is_member(self) -> bool:
        return self.rank >= 0


def initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_device(device) -> torch.device:
    """The resolved device; "cuda" without an index is this process's
    current card (launch.initialize sets it to cuda:{LOCAL_RANK})."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, axis_name: str = "frames", device="cuda") -> Mesh:
    """1-D mesh over the world's first n_devices ranks (all by default).

    Every rank must call it: a sub-mesh is a new process group, which
    torch.distributed creates on all ranks at once. A rank outside the
    sub-mesh gets a mesh with rank -1 and no group. Without an initialised
    torch.distributed this is a size-1 mesh on `device`."""
    dev = rank_device(device)
    if not initialised():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} devices needs as many ranks: call launch.initialize first")
        return Mesh(None, 1, 0, dev, axis_name)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} devices over a world of {world} ranks")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return Mesh(None, n, -1, dev, axis_name)
    return Mesh(group, n, rank, dev, axis_name, dist.get_backend(group))


def _require_member(mesh: Mesh) -> None:
    if not mesh.is_member:
        raise ValueError(f"this process is outside the mesh of {mesh.size} devices")


def psum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The reference's jax.lax.psum over the mesh axis: an all_reduce (sum)
    of t in place on the mesh's group; a no-op without a group."""
    if mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
    return t


def broadcast(mesh: Mesh, *ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The mesh's rank 0 copies of replicated tensors, on every rank (one
    broadcast of their packed values); the tensors themselves without a
    group. A mesh spans the world's first ranks, so its rank 0 is global
    rank 0."""
    if mesh.group is None:
        return ts
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.broadcast(flat, src=0, group=mesh.group)
    return tuple(p.reshape(t.shape) for p, t in zip(torch.split(flat, [t.numel() for t in ts]), ts))


def all_gather_rows(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's (n, ...) block, concatenated in rank order on every rank:
    how a sharded jax array reads whole in one process."""
    if mesh.group is None:
        return local
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local, group=mesh.group)
    return torch.cat(parts)


def local_shard(mesh: Mesh, arr, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of a full host copy along `dim`, on its
    device — the counterpart of the reference's global_array (each process
    serves the shards it addresses from its own full copy). The length must
    divide by the mesh size, as a jax NamedSharding requires."""
    _require_member(mesh)
    t = torch.as_tensor(arr)
    n = t.shape[dim]
    if n % mesh.size:
        raise ValueError(f"axis of length {n} does not divide over {mesh.size} devices")
    b = n // mesh.size
    return t.narrow(dim, mesh.rank * b, b).to(mesh.device)


def ransac_draws(n_pairs: int, cfg: VOConfig, key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(u_hyp, u_lo) of n_pairs pairs on the key's device: pair i draws from
    split(key, n_pairs)[i] (sharding.py:83), as run_sequence's pairs draw."""
    return threefry.ransac_uniforms(threefry.split(key, n_pairs), cfg.ransac)


def _pair_vo_body(fp, fc, corners_prev, corners_curr, mvalid, K, u_hyp, u_lo, *, cfg: VOConfig,
                  real_marker_length: float, mesh: Mesh | None = None) -> torch.Tensor:
    """The pair-VO program on staged device tensors: the 2B frames described
    in one batch, two_frame_vo on the B pairs, and over a mesh the
    all_gather of every rank's rels. No host read and no host data inside."""
    b = fp.shape[0]
    # As in the reference (sharding.py:73-78), the detector takes k, threshold
    # and arc_length only: cfg.frontend, n_levels, scale_factor and
    # dog_threshold are ignored, unlike run_sequence (ROADMAP C.3).
    feats = detect_and_describe_batch(
        torch.cat([fp, fc]), k=cfg.n_keypoints, threshold=cfg.fast_threshold, arc_length=cfg.fast_arc_length
    )
    res = two_frame_vo(
        Features(*(a[:b] for a in feats)),
        Features(*(a[b:] for a in feats)),
        torch.nan_to_num(corners_prev),
        torch.nan_to_num(corners_curr),
        mvalid,
        K,
        real_marker_length,
        cfg,
        u_hyp=u_hyp,
        u_lo=u_lo,
    )
    return res.rel if mesh is None else all_gather_rows(mesh, res.rel)


def _pair_vo_inputs(frames_prev, frames_curr, corners_prev, corners_curr, marker_valid, K, cfg: VOConfig, seed,
                    u_hyp, u_lo, key, dev: torch.device) -> tuple:
    """pair_vo_batched's arguments as the program's inputs on `dev` (host
    values become tensors here, outside the program; the draws are made
    here unless injected)."""
    f32 = lambda a: torch.as_tensor(a).to(dev, torch.float32)
    fp = f32(frames_prev)
    if u_hyp is None:
        u_hyp, u_lo = ransac_draws(fp.shape[0], cfg, threefry.prng_key(seed, dev) if key is None else key.to(dev))
    mvalid = torch.as_tensor(marker_valid).to(dev, torch.bool)
    return (fp, f32(frames_curr), f32(corners_prev), f32(corners_curr), mvalid, f32(K), u_hyp.to(dev),
            None if u_lo is None else u_lo.to(dev))


def pair_vo_batched(
    frames_prev,  # (B, H, W)
    frames_curr,  # (B, H, W)
    corners_prev,  # (B, 4, 2)
    corners_curr,  # (B, 4, 2)
    marker_valid,  # (B,)
    K,
    real_marker_length: float,
    cfg: VOConfig,
    seed: int = 0,
    u_hyp: torch.Tensor | None = None,
    u_lo: torch.Tensor | None = None,
    device="cuda",
    *,
    key: torch.Tensor | None = None,
) -> torch.Tensor:
    """Two-frame VO over a batch of B independent pairs -> (B, 4, 4)
    relative poses. The 2B frames are described in one batch; the RANSAC
    uniforms come from ransac_draws(B, cfg, key), key = PRNGKey(seed) unless
    given, or are injected (u_hyp (B, n_hyp*8), u_lo (B, rounds, 128*14)).
    Shard the B axis over a mesh with shard_pair_vo.

    On a CUDA device this replays one captured CUDA graph per (B, H, W,
    VOConfig, draw form) (the reference's jitted pair_vo_batched); the
    inputs (as float32) and the draws are staged outside it.
    Elsewhere it runs pair_vo_batched_eager."""
    dev = rank_device(device)
    inputs = _pair_vo_inputs(frames_prev, frames_curr, corners_prev, corners_curr, marker_valid, K, cfg, seed,
                             u_hyp, u_lo, key, dev)
    body = functools.partial(_pair_vo_body, cfg=cfg, real_marker_length=float(real_marker_length))
    return graphs.run("pair_vo_batched", body, inputs, (cfg, float(real_marker_length)), dev)


def pair_vo_batched_eager(
    frames_prev,
    frames_curr,
    corners_prev,
    corners_curr,
    marker_valid,
    K,
    real_marker_length: float,
    cfg: VOConfig,
    seed: int = 0,
    u_hyp: torch.Tensor | None = None,
    u_lo: torch.Tensor | None = None,
    device="cuda",
    *,
    key: torch.Tensor | None = None,
) -> torch.Tensor:
    """pair_vo_batched op by op (the captured program's twin)."""
    dev = rank_device(device)
    inputs = _pair_vo_inputs(frames_prev, frames_curr, corners_prev, corners_curr, marker_valid, K, cfg, seed,
                             u_hyp, u_lo, key, dev)
    return _pair_vo_body(*inputs, cfg=cfg, real_marker_length=float(real_marker_length))


def _shard_pair_vo_inputs(mesh: Mesh, frames_prev, frames_curr, corners_prev, corners_curr, marker_valid, K,
                          cfg: VOConfig, seed, u_hyp, u_lo, key) -> tuple:
    """This rank's block of shard_pair_vo's inputs, staged on its device: the
    draws are made for all B pairs and then sliced."""
    _require_member(mesh)
    b = len(frames_prev)
    if b % mesh.size:
        raise ValueError(f"{b} pairs do not divide over {mesh.size} devices")
    if u_hyp is None:
        key = threefry.prng_key(seed, mesh.device) if key is None else key.to(mesh.device)
        u_hyp, u_lo = ransac_draws(b, cfg, key)
    shard = lambda a: local_shard(mesh, a)
    return _pair_vo_inputs(shard(frames_prev), shard(frames_curr), shard(corners_prev), shard(corners_curr),
                           shard(marker_valid), K, cfg, seed, shard(u_hyp), None if u_lo is None else shard(u_lo),
                           None, mesh.device)


def shard_pair_vo(
    mesh: Mesh,
    frames_prev,
    frames_curr,
    corners_prev,
    corners_curr,
    marker_valid,
    K,
    real_marker_length: float,
    cfg: VOConfig,
    seed: int = 0,
    u_hyp: torch.Tensor | None = None,
    u_lo: torch.Tensor | None = None,
    *,
    key: torch.Tensor | None = None,
) -> torch.Tensor:
    """Data-parallel pair VO: rank r runs pairs [r B/D, (r+1) B/D) on its
    device and every rank gets the full (B, 4, 4) back (one all_gather of
    B*16 floats). The draws are made for all B pairs on every rank from
    split(key, B), key = PRNGKey(seed) unless given, and then sliced, so a
    pair's draws do not depend on D. Per-pair work is independent: no other
    collective runs.

    Over an NCCL mesh on the card this replays one captured CUDA graph per
    (B/D, H, W, VOConfig, draw form, mesh), the all_gather
    inside it (the reference's pjit of pair_vo_batched); the shards and the
    draws are staged outside it. On gloo or without a group it runs
    shard_pair_vo_eager (utils/graphs.py)."""
    inputs = _shard_pair_vo_inputs(mesh, frames_prev, frames_curr, corners_prev, corners_curr, marker_valid, K, cfg,
                                   seed, u_hyp, u_lo, key)
    body = functools.partial(_pair_vo_body, cfg=cfg, real_marker_length=float(real_marker_length), mesh=mesh)
    return graphs.run("shard_pair_vo", body, inputs, (cfg, float(real_marker_length)), mesh.device, mesh)


def shard_pair_vo_eager(
    mesh: Mesh,
    frames_prev,
    frames_curr,
    corners_prev,
    corners_curr,
    marker_valid,
    K,
    real_marker_length: float,
    cfg: VOConfig,
    seed: int = 0,
    u_hyp: torch.Tensor | None = None,
    u_lo: torch.Tensor | None = None,
    *,
    key: torch.Tensor | None = None,
) -> torch.Tensor:
    """shard_pair_vo op by op (the captured program's twin)."""
    inputs = _shard_pair_vo_inputs(mesh, frames_prev, frames_curr, corners_prev, corners_curr, marker_valid, K, cfg,
                                   seed, u_hyp, u_lo, key)
    return _pair_vo_body(*inputs, cfg=cfg, real_marker_length=float(real_marker_length), mesh=mesh)
