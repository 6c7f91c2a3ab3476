"""The port's captured device programs (utils/graphs.py), checked on the CPU.

On the card run_sequence, pose_graph.optimize (one GN step a replay),
ba.run_ba and loop-closure verification each replay one CUDA graph per
static signature. A CPU cannot
capture, but it can show the one thing that stops a capture: a host read or
a tensor made from host data inside a program's body. Each body runs here
under a dispatch mode that raises on both (after one warm-up run, as the
capture's warm-up builds the cached per-device constants). Then: the cache
keys of the entry points (a new shape, dtype, config or draw form is a new
program; an equal call reuses one), the cache itself (one capture per key,
least recently used evicted) with a stand-in capture, and the entry points
equal to their eager twins. Small sizes: 6 frames of 448x336.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from droplet_visual_odometry_tpu_torch.backend import ba, loop_closure, pose_graph
from droplet_visual_odometry_tpu_torch.core import se3
from droplet_visual_odometry_tpu_torch.data import synthetic as tsynth
from droplet_visual_odometry_tpu_torch.estimation import vo
from droplet_visual_odometry_tpu_torch.frontend.features import detect_and_describe_batch
from droplet_visual_odometry_tpu_torch.utils import checkpoint, graphs, threefry

torch.set_num_threads(2)

SEQ_CFG = dict(n_frames=6, width=448, height=336, n_landmarks=350)
FLOAT_CFG = dict(match_mode="ratio", dog_threshold=0.5)


class HostGuard(TorchDispatchMode):
    """Raises on what a CUDA graph cannot hold, as far as the dispatcher
    shows it: a read of a tensor's value on the host (`.item()`, `bool()`,
    `int()`), an op whose output shape depends on the data (nonzero,
    boolean-mask indexing), and a tensor made from host data
    (`torch.tensor`, `torch.as_tensor` of a Python or numpy value)."""

    FORBIDDEN = {
        "aten::_local_scalar_dense", "aten::item", "aten::is_nonzero", "aten::equal",
        "aten::nonzero", "aten::masked_select", "aten::unique_dim", "aten::_unique2",
        "aten::unique_consecutive", "aten::repeat_interleave", "aten::lift_fresh", "aten::lift_fresh_copy",
    }

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name in self.FORBIDDEN:
            raise AssertionError(f"host read or host data inside a program: {func}")
        if name in ("aten::index", "aten::index_put", "aten::index_put_", "aten::_index_put_impl_"):
            indices = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(i is not None and i.dtype in (torch.bool, torch.uint8) for i in indices):
                raise AssertionError(f"boolean-mask indexing inside a program: {func}")
        return func(*args, **(kwargs or {}))


def guarded(body, *inputs):
    """body(*inputs) once as a warm-up, then again under HostGuard."""
    body(*inputs)
    with HostGuard():
        return body(*inputs)


@pytest.fixture(scope="module")
def seq():
    return tsynth.render_sequence(tsynth.SyntheticConfig(**SEQ_CFG))


def seq_args(seq, n=None, dtype=torch.float32):
    n = n or len(seq)
    return (torch.from_numpy(seq.frames[:n]).to(dtype), seq.marker_corners[:n], seq.marker_present[:n],
            seq.marker_poses[0], seq.camera.K, seq.real_marker_length)


def sequence_body(seq, cfg, **kw):
    inputs, static = vo._sequence_program(*seq_args(seq), cfg, kw.get("seed", 0), kw.get("u_hyp"), kw.get("u_lo"),
                                          kw.get("init_scale", 1.0), kw.get("key"))
    return lambda *x: vo._sequence_body(*x, **static), inputs


def loop_graph(m=10, seed=3):
    """A chain of m noisy poses with two loop edges (full weights), padded to
    the next buckets, as pose_graph_trajectory pads it."""
    rng = np.random.default_rng(seed)
    xi = torch.from_numpy(rng.normal(0.0, 0.05, (m, 6)).astype(np.float32))
    xi[:, :3] += torch.tensor([0.3, 0.0, 0.0])
    poses = [torch.eye(4)]
    for i in range(1, m):
        poses.append(poses[-1] @ se3.se3_exp(xi[i]))
    poses = torch.stack(poses)
    g = pose_graph.sequential_edges(poses)
    meas = se3.inverse(poses[[0, 2]]) @ poses[[m - 1, m - 2]] @ se3.se3_exp(torch.full((2, 6), 0.01))
    g = pose_graph.add_edges(g, [0, 2], [m - 1, m - 2], meas, torch.full((2, 6), 2.0))
    g = g._replace(poses=g.poses @ se3.se3_exp(torch.from_numpy(rng.normal(0.0, 0.02, (m, 6)).astype(np.float32))))
    return pose_graph.pad_graph(g, pose_graph.next_bucket(m), pose_graph.next_bucket(int(g.edge_i.shape[0])))


def ba_window(w=4, l=40, seed=5):
    """W cameras in a row looking down +z at L points, observed with 0.3 px
    of noise, poses and points perturbed."""
    rng = np.random.default_rng(seed)
    K = np.array([[400.0, 0.0, 224.0], [0.0, 400.0, 168.0], [0.0, 0.0, 1.0]], np.float32)
    pts = rng.uniform([-1, -1, 4], [1, 1, 6], (l, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (w, 1, 1))
    poses[:, 0, 3] = -0.2 * np.arange(w)
    pc = np.einsum("wij,lj->wli", poses[:, :3, :3], pts) + poses[:, None, :3, 3]
    uv = np.stack([K[0, 0] * pc[..., 0] / pc[..., 2] + K[0, 2], K[1, 1] * pc[..., 1] / pc[..., 2] + K[1, 2]], -1)
    uv += rng.normal(0, 0.3, uv.shape)
    noisy = poses.copy()
    noisy[2:, :3, 3] += rng.normal(0, 0.01, (w - 2, 3))
    return ba.BAWindow(
        poses=torch.from_numpy(noisy), points=torch.from_numpy(pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)),
        obs_uv=torch.from_numpy(uv.astype(np.float32)), obs_mask=torch.ones((w, l), dtype=torch.bool),
        K=torch.from_numpy(K),
    )


def verify_case(seq, slots=4):
    """Verification's inputs on the sequence's features: `slots` pairs
    (0, 3), (1, 4), ... with verification's config and reference draws."""
    cfg = loop_closure._verify_vo_config(vo.VOConfig(), loop_closure.LoopClosureConfig())
    feats = detect_and_describe_batch(torch.from_numpy(seq.frames).float(), k=256)
    corners = torch.nan_to_num(torch.from_numpy(seq.marker_corners))
    mvalid = torch.from_numpy(seq.marker_present)
    ca = np.arange(slots, dtype=np.int32) % 3
    cb = ca + 3
    u_hyp, u_lo = loop_closure.reference_draws(slots, cfg.ransac)
    K = torch.from_numpy(seq.camera.K.astype(np.float32))
    return (feats, corners, mvalid, K, seq.real_marker_length, cfg, ca, cb, u_hyp, u_lo)


# --------------------------------------------------------------------------
# No host read and no host data inside a body
# --------------------------------------------------------------------------

@pytest.mark.parametrize("frontend", ["orb", "sift", "surf"])
def test_run_sequence_body_has_no_host_read(seq, frontend):
    extra = {} if frontend == "orb" else FLOAT_CFG
    cfg = vo.VOConfig(frontend=frontend, scale_mode="hold", **extra)
    body, inputs = sequence_body(seq, cfg, init_scale=0.5)
    out = guarded(body, *inputs)
    assert out.abs_poses.shape == (len(seq), 4, 4) and bool(torch.isfinite(out.abs_poses).all())


def test_run_sequence_body_with_injected_draws_has_no_host_read(seq):
    keys = threefry.split(threefry.prng_key(4), len(seq) - 1)
    u_hyp, u_lo = threefry.ransac_uniforms(keys, vo.VOConfig().ransac)
    body, inputs = sequence_body(seq, vo.VOConfig(), u_hyp=u_hyp, u_lo=u_lo)
    guarded(body, *inputs)


def test_optimize_body_has_no_host_read():
    g = loop_graph()
    out = guarded(lambda *t: pose_graph.optimize_eager(pose_graph.PoseGraph(*t)), *g)
    assert float(out.final_cost) < float(out.initial_cost)


def test_run_ba_body_has_no_host_read():
    out = guarded(lambda *t: ba.run_ba_eager(ba.BAWindow(*t), ba.BAConfig(n_fixed=2)), *ba_window())
    assert float(out.final_cost) < float(out.initial_cost)


def test_verify_body_has_no_host_read(seq):
    feats, corners, mvalid, K, L, cfg, ca, cb, u_hyp, u_lo = verify_case(seq)
    inputs = loop_closure._verify_inputs(feats, corners, mvalid, K, ca, cb, u_hyp, u_lo)
    out = guarded(lambda *t: loop_closure._verify_body(*t, vo_cfg=cfg, real_marker_length=L), *inputs)
    assert out.rel.shape == (len(ca), 4, 4)


def test_guard_catches_host_reads():
    x = torch.arange(6.0)
    for op in (lambda: x.sum().item(), lambda: bool(x[0] > 1), lambda: x[x > 2], lambda: torch.nonzero(x),
               lambda: torch.as_tensor(np.ones(3)), lambda: torch.tensor([1.0, 2.0])):
        with pytest.raises(AssertionError), HostGuard():
            op()
    with HostGuard():  # what a body may do
        torch.where(x > 2, x, 0.0).sum() * 2.0 + torch.full((), 1.5)


# --------------------------------------------------------------------------
# Cache keys of the entry points
# --------------------------------------------------------------------------

def keys_of(calls):
    """The cache key of each call, recorded through graphs.run (which runs
    the body eagerly here, on the CPU); a call that replays its program more
    than once (optimize: once a GN step) must use one key throughout."""
    keys = []
    real = graphs.run

    def spy(name, body, inputs, static, device, mesh=None):
        keys[-1].append(graphs._key(name, static, inputs, torch.device(device), mesh))
        return real(name, body, inputs, static, device, mesh)

    with mock.patch.object(graphs, "run", spy):
        for call in calls:
            keys.append([])
            call()
    assert all(len(set(k)) == 1 for k in keys)
    return [k[0] for k in keys]


def test_run_sequence_keys(seq):
    cfg = vo.VOConfig(n_keypoints=128, ransac=dataclasses.replace(vo.VOConfig().ransac, n_hypotheses=32))
    keys_ = threefry.split(threefry.prng_key(1), len(seq) - 1)
    u_hyp, u_lo = threefry.ransac_uniforms(keys_, cfg.ransac)
    k = keys_of([
        lambda: vo.run_sequence(*seq_args(seq), cfg),
        lambda: vo.run_sequence(*seq_args(seq), cfg, seed=9, init_scale=0.7),  # equal signature
        lambda: vo.run_sequence(*seq_args(seq, n=5), cfg),  # N
        lambda: vo.run_sequence(*seq_args(seq, dtype=torch.uint8), cfg),  # frame dtype
        lambda: vo.run_sequence(*seq_args(seq), dataclasses.replace(cfg, scale_mode="hold")),  # VOConfig
        lambda: vo.run_sequence(*seq_args(seq), cfg, u_hyp=u_hyp, u_lo=u_lo),  # draw form
    ])
    assert k[0] == k[1]
    assert len(set(k)) == 5


def test_optimize_keys():
    """optimize replays one GN step's program cfg.iters times: one key a call."""
    cfg = pose_graph.PoseGraphConfig(iters=2, cg_iters=5)
    g16 = loop_graph(10)
    g32 = loop_graph(20)
    k = keys_of([
        lambda: pose_graph.optimize(g16, cfg),
        lambda: pose_graph.optimize(loop_graph(10, seed=4), cfg),  # equal (M, E)
        lambda: pose_graph.optimize(g32, cfg),  # padded M
        lambda: pose_graph.optimize(pose_graph.pad_graph(g16, 16, 32), cfg),  # padded E
        lambda: pose_graph.optimize(g16, dataclasses.replace(cfg, iters=3)),  # config
    ])
    assert k[0] == k[1]
    assert len(set(k)) == 4


def test_run_ba_keys():
    cfg = ba.BAConfig(iters=2)
    k = keys_of([
        lambda: ba.run_ba(ba_window(4, 40), cfg),
        lambda: ba.run_ba(ba_window(4, 40, seed=6), cfg),  # equal (W, L)
        lambda: ba.run_ba(ba_window(5, 40), cfg),  # W
        lambda: ba.run_ba(ba_window(4, 48), cfg),  # L
        lambda: ba.run_ba(ba_window(4, 40), dataclasses.replace(cfg, n_fixed=2)),  # config
    ])
    assert k[0] == k[1]
    assert len(set(k)) == 4


def test_verify_keys(seq):
    feats, corners, mvalid, K, L, cfg, ca, cb, u_hyp, u_lo = verify_case(seq, slots=4)
    u8 = loop_closure.reference_draws(8, cfg.ransac)
    ca8, cb8 = np.arange(8) % 3, np.arange(8) % 3 + 3
    feats128 = detect_and_describe_batch(torch.from_numpy(seq.frames).float(), k=128)
    k = keys_of([
        lambda: loop_closure._verify_candidates(feats, corners, mvalid, K, L, cfg, ca, cb, u_hyp, u_lo),
        lambda: loop_closure._verify_candidates(feats, corners, mvalid, K, L, cfg, cb - 3, ca + 3, u_hyp, u_lo),
        lambda: loop_closure._verify_candidates(feats, corners, mvalid, K, L, cfg, ca8, cb8, *u8),  # slots P
        lambda: loop_closure._verify_candidates(feats128, corners, mvalid, K, L, cfg, ca, cb, u_hyp, u_lo),  # K
    ])
    assert k[0] == k[1]
    assert len(set(k)) == 3


# --------------------------------------------------------------------------
# The cache, with a stand-in capture
# --------------------------------------------------------------------------

class _StubGraph:
    def __init__(self):
        self.reset_calls = 0

    def reset(self):
        self.reset_calls += 1


def test_cache_captures_once_per_key_and_evicts_least_recent():
    captured = []

    def fake_capture(name, body, inputs, device, mesh=None):
        captured.append(name)
        return graphs.Program(name=name, graph=_StubGraph(), inputs=(), outputs=None, captured_launches={},
                              capture_s=0.0, memory_bytes=0)

    dev = torch.device("cuda", 0)
    x = torch.zeros(3)
    with mock.patch.object(graphs, "_capture", fake_capture), mock.patch.object(graphs, "_cache", {}):
        first = graphs.program("p0", None, (x,), 0, dev)
        assert graphs.program("p0", None, (torch.ones(3),), 0, dev) is first  # same signature
        for i in range(1, graphs.CAPACITY):
            graphs.program(f"p{i}", None, (x,), 0, dev)
        graphs.program("p0", None, (x,), 0, dev)  # p0 is now the most recent
        graphs.program("extra", None, (x,), 0, dev)  # evicts p1, the least recent
        assert [p.name for p in graphs.programs(dev)][:2] == ["p2", "p3"]
        assert len(graphs.programs(dev)) == graphs.CAPACITY
        assert captured == [f"p{i}" for i in range(graphs.CAPACITY)] + ["extra"]
        graphs.program("p1", None, (x,), 0, dev)  # captured again
        assert captured[-1] == "p1"
        held = graphs.programs(dev)
        graphs.clear(dev)
        assert graphs.programs(dev) == [] and all(p.graph.reset_calls == 1 for p in held)


# --------------------------------------------------------------------------
# Entry points and their eager twins, and the staged inputs (CPU)
# --------------------------------------------------------------------------

def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_run_sequence_equals_eager_and_init_scale_forms(seq):
    cfg = vo.VOConfig(scale_mode="hold")
    args = seq_args(seq)
    present = np.asarray(seq.marker_present).copy()
    present[:] = False  # no live scale: every pair holds init_scale
    args = args[:2] + (present,) + args[3:]
    a = vo.run_sequence(*args, cfg, init_scale=0.25)
    b = vo.run_sequence(*args, cfg, init_scale=torch.tensor(0.25))
    c = vo.run_sequence_eager(*args, cfg, init_scale=np.float32(0.25))
    _equal(a, b)
    _equal(a, c)
    np.testing.assert_array_equal(a.scales.numpy(), np.full(len(seq) - 1, 0.25, np.float32))


def test_optimize_run_ba_verify_equal_eager(seq):
    cfg = pose_graph.PoseGraphConfig(iters=3)
    g = loop_graph()
    _equal(pose_graph.optimize(g, cfg), pose_graph.optimize_eager(g, cfg))
    w = ba_window()
    _equal(ba.run_ba(w, ba.BAConfig(n_fixed=2)), ba.run_ba_eager(w, ba.BAConfig(n_fixed=2)))
    case = verify_case(seq)
    _equal(loop_closure._verify_candidates(*case), loop_closure._verify_candidates_eager(*case))


def test_checkpointed_chunks_share_one_signature(seq):
    """Every chunk of a streamed run, the padded last one included, is one
    program signature: the entry the card replays for all of them."""
    cfg = vo.VOConfig(n_keypoints=128, scale_mode="hold")
    calls = []
    real = graphs.run

    def spy(name, body, inputs, static, device, mesh=None):
        calls.append(graphs._key(name, static, inputs, torch.device(device), mesh))
        return real(name, body, inputs, static, device, mesh)

    with mock.patch.object(graphs, "run", spy):
        checkpoint.run_sequence_checkpointed(
            seq.frames, seq.marker_corners, seq.marker_present, seq.marker_poses[0], seq.camera.K,
            seq.real_marker_length, cfg, path=None, chunk=2, device="cpu")
    assert len(calls) == 3 and len(set(calls)) == 1
