"""Captured device programs: the port's counterpart of
`jax.jit(fn, static_argnames=...)`.

The JAX package runs each of its hot device programs (the VO sequence, the
pose-graph Gauss-Newton, windowed BA, loop-closure verification) as one
compiled XLA program: no host launch or read inside it. Here each becomes
one CUDA graph per static signature:

    out = graphs.run(name, body, inputs, static, device, mesh=None)

`body(*inputs)` is the program's op-by-op form: it takes tensors (or None)
and returns a tensor or a (named) tuple of tensors, and it must neither
read the device back to the host nor make a tensor from host data (the
cached constants of `utils/device.constant` are made by the warm-up).
`static` is the hashable rest of the call (frozen config dataclasses,
Python scalars). The cache key is (name, static, the inputs' shapes and
dtypes with None kept as None, the device), so, as with static arguments
under jit, a new shape, dtype, config or draw form captures a new program.

On a CUDA device the first call with a key allocates one static buffer per
input, copies the inputs in, runs `body` once on a side stream (so cuBLAS
handles, kernel libraries and per-device constants load outside the
capture), captures `body` with `torch.cuda.graph` into a private memory
pool and keeps its outputs as the static outputs. Every call (the first
included) then copies each input into its buffer (host or device tensors;
a device-to-device copy for a tensor already on the card), replays the
graph once and returns clones of the static outputs, never buffers the next
replay overwrites. On any other device `body` runs eagerly: graphs exist
only on CUDA devices, so the device decides; there is no switch and no
eager fallback on the card, and a capture that fails raises.

What the cache holds: per device, the CAPACITY most recently used programs
(and as many per process group for the programs over a mesh, below), each
its graph, its pool (the body's peak working set: about 11 GB for a
257-frame stream chunk at 1440x1080) and its static buffers. An evicted
program's graph is reset and its pool returned to the device.

Launch counters: the kernels' counters (ops/cuda_*.LAUNCHES) tick where a
wrapper's Python runs, i.e. in the warm-up and in the capture, never on a
replay. Each program records `captured_launches`, the launches of one
replay.

Programs over a mesh (`run(..., mesh=m)`, m a parallel.sharding.Mesh): the
JAX package compiles its sharded programs (pjit pair VO, the shard_map BA,
the edge-sharded PCG) with their collectives inside. Here the collectives
are torch.distributed calls on the mesh's group inside `body`, and the
group's backend decides, as the device does: a group on NCCL is captured
with its collectives in the graph (NCCL enqueues them on the card like any
kernel); on gloo, which runs a collective on the host, and for a mesh
without a group, `body` runs op by op. That is the rule, not a fallback: a
failed NCCL capture raises. The key then also holds the mesh's identity
(group, size, rank, backend), so a sharded program never shares a key with
its one-device form, and a new process group (even of the same size)
captures anew. A captured collective holds its communicator: drop a mesh's
programs with `clear(mesh=m)` before its group is destroyed
(parallel.launch.shutdown does so for every group), or a later replay or
an eviction would touch a dead communicator.

Lockstep: every rank of a mesh must capture at the same call, since a
call that captures runs the body's collectives twice (the warm-up, then
the replay) and a call that replays runs them once. The cache keeps that
by itself: a capture happens at a key's first call and an eviction at the
call that overflows CAPACITY, both fixed by the sequence of calls, and the
programs over a mesh are kept in an LRU of their own per (device, process
group). So their captures and evictions follow only the calls over that
group, which every member makes in the same order (as its collectives
require anyway), and not a rank's other calls: one-device programs, or
sub-meshes it is not part of.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Hashable, Sequence

import torch
from torch.utils import _pytree as pytree

CAPACITY = 6  # captured programs kept per device


def launch_counts() -> dict[str, int]:
    """The three kernels' launch counters, read now."""
    from droplet_visual_odometry_tpu_torch.ops import cuda_describe, cuda_fast, cuda_match

    return {"fast_score": cuda_fast.LAUNCHES, "orb_describe": cuda_describe.LAUNCHES,
            "hamming_match": cuda_match.LAUNCHES}


@dataclasses.dataclass
class Program:
    """One captured program and what it cost."""

    name: str
    graph: torch.cuda.CUDAGraph
    inputs: tuple  # static input buffers (None where the signature has None)
    outputs: Any  # the static outputs, as the body returned them
    captured_launches: dict[str, int]  # kernel launches of one replay
    capture_s: float  # host wall of warm-up + capture
    memory_bytes: int  # the graph's pool (memory_reserved growth over the capture) + static input bytes
    mesh: Any = None  # the parallel.sharding.Mesh whose collectives the graph holds (None: one device)


_cache: dict[tuple, collections.OrderedDict] = {}  # (device, process group or None) -> LRU of programs


def _mesh_id(mesh) -> tuple | None:
    return None if mesh is None else (mesh.group, mesh.size, mesh.rank, mesh.backend)


def _key(name: str, static: Hashable, inputs: Sequence, device: torch.device, mesh=None) -> tuple:
    sig = tuple(None if x is None else (tuple(x.shape), x.dtype) for x in inputs)
    return (name, static, sig, device, _mesh_id(mesh))


def _stage(buffers: tuple, inputs: Sequence) -> None:
    for buf, x in zip(buffers, inputs):
        if buf is not None:
            buf.copy_(x, non_blocking=True)


def _capture(name: str, body: Callable, inputs: Sequence, device: torch.device, mesh=None) -> Program:
    t0 = time.perf_counter()
    buffers = tuple(None if x is None else torch.empty(x.shape, dtype=x.dtype, device=device) for x in inputs)
    _stage(buffers, inputs)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body(*buffers)  # warm-up: outputs dropped, inputs untouched
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    # torch.cuda.graph empties the allocator's cache as it starts: empty it
    # first, so the growth of reserved memory is the graph's own pool.
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    before = launch_counts()
    with torch.cuda.graph(graph):
        outputs = body(*buffers)
    captured = {k: v - before[k] for k, v in launch_counts().items()}
    torch.cuda.synchronize(device)
    in_bytes = sum(b.numel() * b.element_size() for b in buffers if b is not None)
    return Program(
        name=name, graph=graph, inputs=buffers, outputs=outputs, captured_launches=captured,
        capture_s=time.perf_counter() - t0,
        memory_bytes=torch.cuda.memory_reserved(device) - reserved + in_bytes, mesh=mesh,
    )


def _drop(prog: Program) -> None:
    prog.graph.reset()
    prog.inputs = prog.outputs = None


def _evict(programs: collections.OrderedDict) -> None:
    _drop(programs.popitem(last=False)[1])
    torch.cuda.empty_cache()


def program(name: str, body: Callable, inputs: Sequence, static: Hashable, device, mesh=None) -> Program:
    """The cached program for this call's signature, captured now if absent
    (CUDA devices only)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    programs = _cache.setdefault((device, None if mesh is None else mesh.group), collections.OrderedDict())
    key = _key(name, static, inputs, device, mesh)
    prog = programs.get(key)
    if prog is None:
        prog = _capture(name, body, inputs, device, mesh)
        programs[key] = prog
        while len(programs) > CAPACITY:
            _evict(programs)
    programs.move_to_end(key)
    return prog


def run(name: str, body: Callable, inputs: Sequence, static: Hashable, device, mesh=None) -> Any:
    """body(*inputs) on `device`, over `mesh` if given (its collectives
    inside `body`): on a CUDA device, with no mesh or a mesh on NCCL, one
    replay of the program captured for this signature; else eagerly (see
    the module docstring)."""
    device = torch.device(device)
    if device.type != "cuda" or (mesh is not None and mesh.backend != "nccl"):
        return body(*(None if x is None else x.to(device) for x in inputs))
    prog = program(name, body, inputs, static, device, mesh)
    _stage(prog.inputs, inputs)
    prog.graph.replay()
    return pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, prog.outputs)


def _caches(device, mesh) -> list[collections.OrderedDict]:
    return [progs for (d, group), progs in _cache.items()
            if (device is None or d == torch.device(device)) and (mesh is None or group is mesh.group)]


def programs(device=None) -> list[Program]:
    """The cached programs (all devices unless one is given), least
    recently used first within each device's and each group's LRU."""
    return [p for progs in _caches(device, None) for p in progs.values()]


def clear(device=None, mesh=None) -> None:
    """Drop cached programs (of one device, or all), freeing their pools:
    every program, or with `mesh` only those whose graphs hold collectives
    on the mesh's process group. The next call of each signature captures
    again."""
    for progs in _caches(device, mesh):
        while progs:
            _drop(progs.popitem(last=False)[1])
    torch.cuda.empty_cache()
