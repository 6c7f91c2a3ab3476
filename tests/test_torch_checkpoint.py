"""The port's chunked streaming path vs the JAX reference (CPU).

Modules: utils/checkpoint.py (atomic state, resume, stale state, chunk
structure, the reference's per-chunk draws replayed), the 'hold' chunk carry
of estimation/vo.run_sequence, data/native_store.py (VOSTORE1 files across
packages), and pipeline.run_experiment's streaming branch (against the
reference's streamed run, from a store, and the automatic 2 GiB switch).
Tolerances are stated per test.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu import pipeline as jpipe
from droplet_visual_odometry_tpu.data import native_store as jstore
from droplet_visual_odometry_tpu.data import synthetic as jsynth
from droplet_visual_odometry_tpu.estimation import vo as jvo
from droplet_visual_odometry_tpu.eval import tum as jtum
from droplet_visual_odometry_tpu.utils import checkpoint as jck

from droplet_visual_odometry_tpu_torch import pipeline as tpipe
from droplet_visual_odometry_tpu_torch.data import native_store as tstore
from droplet_visual_odometry_tpu_torch.data import synthetic as tsynth
from droplet_visual_odometry_tpu_torch.estimation import vo as tvo
from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig
from droplet_visual_odometry_tpu_torch.eval import tum as ttum
from droplet_visual_odometry_tpu_torch.utils import checkpoint as tck
from droplet_visual_odometry_tpu_torch.utils import threefry

from torch_backend_data import jax_chunk_draws

torch.set_num_threads(2)

# test_torch_pipeline.py's sequence; the marker absent on frames 3-6, so the
# held scale crosses the boundary of the chunks of 4 pairs (pairs 1-4, 5-8,
# then pair 9 padded to 4).
SEQ_CFG = dict(n_frames=10, width=640, height=480, n_landmarks=350)
ABSENT = slice(3, 7)
CHUNK = 4
HOLD = dict(scale_mode="hold")


def _mask(seq):
    present = seq.marker_present.copy()
    corners = seq.marker_corners.copy()
    present[ABSENT] = False
    corners[ABSENT] = np.nan
    return dataclasses.replace(seq, marker_present=present, marker_corners=corners)


@pytest.fixture(scope="module")
def seqs():
    return _mask(jsynth.render_sequence(jsynth.SyntheticConfig(**SEQ_CFG))), \
        _mask(tsynth.render_sequence(tsynth.SyntheticConfig(**SEQ_CFG)))


@pytest.fixture(scope="module")
def jax_stream(seqs, tmp_path_factory):
    """The reference's streamed run_experiment (seed 0, chunk 4)."""
    d = tmp_path_factory.mktemp("jax_stream")
    res = jpipe.run_experiment(seqs[0], jvo.VOConfig(**HOLD), out_dir=str(d / "out"), seed=0,
                               checkpoint_path=str(d / "state.npz"), checkpoint_chunk=CHUNK)
    return res, str(d / "out")


def _ckpt_args(seq):
    return (seq.frames, np.asarray(seq.marker_corners, np.float32), seq.marker_present,
            np.asarray(seq.marker_poses[0], np.float32), np.asarray(seq.camera.K, np.float32), seq.real_marker_length)


# --------------------------------------------------------------------------
# run_sequence_checkpointed against the reference
# --------------------------------------------------------------------------


def test_checkpointed_matches_reference(seqs, jax_stream):
    """The reference's per-chunk threefry draws replayed: 3 chunks, the last
    padded, the held scale carried across the absent-marker boundary. The
    same tolerances as test_run_sequence_matches_reference: match counts,
    ok and live-scale bits equal; inlier counts equal on all but at most
    one pair, within 2%; relative poses and applied scales to 5e-3. The
    absolute poses to 1.2e-2: pair 2's pose comes out about 1 degree and
    1.4% in scale apart on the same inliers (XLA's fused f32 against
    op-by-op f32, ROADMAP C), the hold repeats that scale over the next five
    pairs and the chain sums the steps (measured 9.7e-3)."""
    ref = jax_stream[0].trajectory
    out = tck.run_sequence_checkpointed(*_ckpt_args(seqs[1]), tvo.VOConfig(**HOLD), path=None, chunk=CHUNK,
                                        draws=jax_chunk_draws(0), device="cpu")
    assert out.abs_poses.shape == (len(seqs[1]), 4, 4) and out.n_matches.shape == (len(seqs[1]) - 1,)
    np.testing.assert_array_equal(out.n_matches, np.asarray(ref.n_matches))
    ni, ni_ref = out.n_inliers, np.asarray(ref.n_inliers)
    print(f"n_inliers port {ni.tolist()} reference {ni_ref.tolist()}; scales {out.scales.tolist()}")
    assert (ni != ni_ref).sum() <= 1
    assert np.all(np.abs(ni - ni_ref) <= 0.02 * ni_ref)
    np.testing.assert_array_equal(out.ok, np.asarray(ref.ok))
    np.testing.assert_array_equal(out.scale_ok, np.asarray(ref.scale_ok))
    assert not out.scale_ok[2:7].any() and out.scale_ok[:2].all()
    np.testing.assert_allclose(out.scales, np.asarray(ref.scales), atol=5e-3)
    np.testing.assert_array_equal(out.scales[2:7], np.full(5, out.scales[1]))  # held across the boundary
    np.testing.assert_allclose(out.rel_poses, np.asarray(ref.rel_poses), atol=5e-3)
    np.testing.assert_allclose(out.abs_poses, np.asarray(ref.abs_poses), atol=1.2e-2)


def test_init_scale_matches_reference(seqs):
    """run_sequence's chunk carry on a chunk with no live marker: every
    applied scale is the carried init_scale, exactly as the reference's
    (same draws); match counts equal and relative poses to 5e-3 (the
    carried scale is of this sequence's size: its marker steps are
    0.109-0.117 m)."""
    seq = seqs[1]
    frames = seq.frames[:5]
    corners = np.asarray(seq.marker_corners[:5], np.float32)
    absent = np.zeros(5, bool)
    init = np.asarray(seq.marker_poses[0], np.float32)
    K = np.asarray(seq.camera.K, np.float32)
    ref = jvo.run_sequence(
        jax.random.fold_in(jax.random.PRNGKey(0), 1), jnp.asarray(frames, jnp.float32), jnp.asarray(corners),
        jnp.asarray(absent), jnp.asarray(init), jnp.asarray(K), seq.real_marker_length, jvo.VOConfig(**HOLD),
        init_scale=jnp.asarray(0.12, jnp.float32), init_scale_seen=jnp.asarray(True),
    )
    u_hyp, u_lo = jax_chunk_draws(0)(1, 4)
    out = tvo.run_sequence(torch.from_numpy(frames).float(), corners, absent, init, K, seq.real_marker_length,
                           tvo.VOConfig(**HOLD), u_hyp=u_hyp, u_lo=u_lo, init_scale=0.12, init_scale_seen=True)
    np.testing.assert_array_equal(out.scales.numpy(), np.asarray(ref.scales))
    np.testing.assert_array_equal(out.scales.numpy(), np.full(4, np.float32(0.12)))
    np.testing.assert_array_equal(out.n_matches.numpy(), np.asarray(ref.n_matches))
    np.testing.assert_allclose(out.rel_poses.numpy(), np.asarray(ref.rel_poses), atol=5e-3)


def test_streamed_run_experiment_matches_reference(seqs, jax_stream, tmp_path):
    """run_experiment(stream=True, checkpoint_path=...) with the port's own
    draws against the reference's streamed run: the same six files, the
    ground truth byte-identical, the match counts equal (no draw comes
    before matching), all pairs ok, and the ATE within 0.02 m of the
    reference's (test_torch_pipeline's band: the port draws another RANSAC
    stream)."""
    jres, jdir = jax_stream
    tdir = str(tmp_path / "out")
    res = tpipe.run_experiment(seqs[1], tvo.VOConfig(**HOLD), tdir, 0, stream=True,
                               checkpoint_path=str(tmp_path / "state.npz"), checkpoint_chunk=CHUNK, device="cpu")
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == sorted(ttum.STREAM_NAMES)
    for name in ("stamped_ground_truth_absolute.txt", "stamped_ground_truth_relative.txt"):
        with open(os.path.join(tdir, name)) as f, open(os.path.join(jdir, name)) as g:
            t_lines, j_lines = f.read().splitlines(), g.read().splitlines()
        if name.endswith("absolute.txt"):
            assert t_lines == j_lines
        else:
            np.testing.assert_allclose(ttum.read_tum(os.path.join(tdir, name))[1],
                                       jtum.read_tum(os.path.join(jdir, name))[1], atol=1e-5)
    for name in ttum.STREAM_NAMES:
        stamps, poses = ttum.read_tum(os.path.join(tdir, name))
        assert np.isfinite(poses).all() and len(stamps) == len(jtum.read_tum(os.path.join(jdir, name))[0])
    np.testing.assert_array_equal(res.trajectory.n_matches, np.asarray(jres.trajectory.n_matches))
    assert res.trajectory.ok.all()
    print(f"ATE port {res.ate.rmse} reference {jres.ate.rmse}")
    assert abs(res.ate.rmse - jres.ate.rmse) < 0.02
    st = tck.load_state(str(tmp_path / "state.npz"))
    assert int(st["next_start"]) == len(seqs[1]) and int(st["chunk"]) == CHUNK


def _stop_at_chunk_2(done, n):
    """A progress callback that raises at the second chunk (pairs 5-8)."""
    if done > CHUNK + 1:
        raise KeyboardInterrupt


def _reference_state_after_chunk_1(seq, path):
    """The reference's run_sequence_checkpointed interrupted by a progress
    callback at chunk 2: its state file at `path`."""
    args = list(_ckpt_args(seq))
    args[1] = np.nan_to_num(args[1])
    with pytest.raises(KeyboardInterrupt):
        jck.run_sequence_checkpointed(jax.random.PRNGKey(0), *args, jvo.VOConfig(**HOLD), path=path, chunk=CHUNK,
                                      progress=_stop_at_chunk_2)
    return args


def test_raising_progress_leaves_the_reference_state(seqs, jax_stream, tmp_path):
    """progress(stop, n) comes before the chunk's save, as in the reference:
    a callback that raises at chunk 2 leaves chunk 1 saved in both packages,
    with the same next_start (5), the same entries (the run key among them,
    equal) and the same match counts."""
    jp, tp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    _reference_state_after_chunk_1(seqs[0], jp)
    with pytest.raises(KeyboardInterrupt):
        tck.run_sequence_checkpointed(*_ckpt_args(seqs[1]), tvo.VOConfig(**HOLD), path=tp, chunk=CHUNK,
                                      progress=_stop_at_chunk_2, draws=jax_chunk_draws(0), device="cpu")
    js, ts = jck.load_state(jp), tck.load_state(tp)
    assert int(ts["next_start"]) == int(js["next_start"]) == CHUNK + 1
    assert sorted(ts) == sorted(js)
    np.testing.assert_array_equal(ts["key"], js["key"])
    np.testing.assert_array_equal(ts["n_matches"], js["n_matches"])


def test_state_without_scale_carry_resumes_as_the_reference(seqs, jax_stream, tmp_path):
    """A state file without scale_last and scale_seen (written before the
    'hold' carry existed) resumes with the reference's defaults, 1.0 and
    False: the held pairs 5-7 of the resumed chunk apply 1.0 in both
    packages (with the carry they would hold pair 2's live scale), the match
    counts are equal and the applied scales agree to 5e-3."""
    jp, tp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    args = _reference_state_after_chunk_1(seqs[0], jp)
    old = {k: v for k, v in jck.load_state(jp).items() if k not in ("scale_last", "scale_seen")}
    for p in (jp, tp):
        tck.save_state(p, old)
    ref = jck.run_sequence_checkpointed(jax.random.PRNGKey(0), *args, jvo.VOConfig(**HOLD), path=jp, chunk=CHUNK)
    out = tck.run_sequence_checkpointed(*_ckpt_args(seqs[1]), tvo.VOConfig(**HOLD), path=tp, chunk=CHUNK,
                                        draws=jax_chunk_draws(0), device="cpu")
    print(f"scales port {out.scales.tolist()} reference {np.asarray(ref.scales).tolist()}")
    np.testing.assert_array_equal(out.n_matches, np.asarray(ref.n_matches))
    np.testing.assert_array_equal(out.scales[4:7], np.ones(3, np.float32))
    np.testing.assert_array_equal(out.scales[4:7], np.asarray(ref.scales)[4:7])
    np.testing.assert_allclose(out.scales, np.asarray(ref.scales), atol=5e-3)


# --------------------------------------------------------------------------
# Checkpoint mechanics (port only, tiny sequences)
# --------------------------------------------------------------------------

TINY_CFG = tvo.VOConfig(n_keypoints=64, ransac=RansacConfig(n_hypotheses=64, lo_hypotheses=16))


def _tiny(n=7):
    seq = tsynth.render_sequence(tsynth.SyntheticConfig(n_frames=n, width=96, height=72, n_landmarks=50))
    return _ckpt_args(seq)


def _equal(a, b):
    for f in tvo.VOTrajectory._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_save_state_is_atomic(tmp_path):
    p = str(tmp_path / "s.npz")
    tck.save_state(p, {"a": np.arange(3)})
    assert {f.name for f in tmp_path.iterdir()} == {"s.npz"}
    np.testing.assert_array_equal(tck.load_state(p)["a"], np.arange(3))
    assert tck.load_state(str(tmp_path / "missing.npz")) is None


@pytest.mark.parametrize("interrupt", ["progress", "save"])
def test_resume_equals_uninterrupted(tmp_path, monkeypatch, interrupt):
    """Interrupted after the first chunk of 3 pairs is saved (by a progress
    callback that raises at the second chunk, before that chunk's save, as
    the reference orders them; or inside the first state write after the
    rename), then resumed: bit for bit the uninterrupted run, with the
    port's own seeded draws."""
    args = _tiny()
    full = tck.run_sequence_checkpointed(*args, TINY_CFG, path=str(tmp_path / "full.npz"), chunk=3, device="cpu")
    assert full.abs_poses.shape == (7, 4, 4)
    p = str(tmp_path / "int.npz")
    kw = dict(path=p, chunk=3, device="cpu")
    if interrupt == "progress":
        def stop(done, n):
            if done > 4:
                raise KeyboardInterrupt

        with pytest.raises(KeyboardInterrupt):
            tck.run_sequence_checkpointed(*args, TINY_CFG, progress=stop, **kw)
    else:
        save = tck.save_state

        def bomb(path, state):
            save(path, state)
            raise KeyboardInterrupt

        monkeypatch.setattr(tck, "save_state", bomb)
        with pytest.raises(KeyboardInterrupt):
            tck.run_sequence_checkpointed(*args, TINY_CFG, **kw)
        monkeypatch.setattr(tck, "save_state", save)
    assert int(tck.load_state(p)["next_start"]) == 4  # one chunk of 3 pairs done
    _equal(tck.run_sequence_checkpointed(*args, TINY_CFG, **kw), full)


def test_stale_state_restarts(tmp_path):
    args = _tiny(5)
    p = str(tmp_path / "c.npz")
    tck.save_state(p, {"n_total": np.asarray(999), "chunk": np.asarray(3)})
    traj = tck.run_sequence_checkpointed(*args, TINY_CFG, path=p, chunk=2, device="cpu")
    assert traj.abs_poses.shape == (5, 4, 4)
    st = tck.load_state(p)
    assert int(st["n_total"]) == 5 and int(st["next_start"]) == 5


def test_one_chunk_equals_run_sequence():
    """A chunk covering the whole sequence (no padding) is run_sequence with
    the same injected draws, bit for bit."""
    args = _tiny()
    g = torch.Generator().manual_seed(3)
    u_hyp, u_lo = torch.rand((6, 64 * 8), generator=g), torch.rand((6, 16 * 14), generator=g)
    out = tck.run_sequence_checkpointed(*args, TINY_CFG, path=None, chunk=6, draws=lambda s, n: (u_hyp, u_lo),
                                        device="cpu")
    frames, *rest = args
    ref = tvo.run_sequence(torch.from_numpy(frames).float(), *rest, TINY_CFG, u_hyp=u_hyp, u_lo=u_lo)
    _equal(out, tvo.VOTrajectory(*(t.numpy() for t in ref)))


def test_padded_chunk_is_sliced_off():
    """Chunk sizes that do and do not pad the last chunk give the same
    trajectory length, finite values, and the same pairs where their draws
    coincide (the first chunk of 3 pairs draws the same either way: its key
    is fold_in(PRNGKey(seed), start), a function of (seed, start) alone, and
    split's first keys do not depend on the count), with each chunk's key
    that of the reference (checkpoint.py:127)."""
    args = _tiny()
    a = tck.run_sequence_checkpointed(*args, TINY_CFG, path=None, chunk=3, device="cpu")  # 6 pairs: 3 + 3
    b = tck.run_sequence_checkpointed(*args, TINY_CFG, path=None, chunk=4, device="cpu")  # 4 + 2 padded to 4
    for t in (a, b):
        assert t.abs_poses.shape == (7, 4, 4) and t.n_matches.shape == (6,)
        assert np.isfinite(t.abs_poses).all() and np.isfinite(t.scales).all()
    np.testing.assert_array_equal(a.n_matches, b.n_matches)
    for seed, start in ((0, 1), (0, 4), (1, 4)):
        np.testing.assert_array_equal(threefry.fold_in(threefry.prng_key(seed), start).numpy(),
                                      np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), start)).astype(np.int64))
    np.testing.assert_array_equal(a.rel_poses[:3], b.rel_poses[:3])


# --------------------------------------------------------------------------
# Native store
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def store_data():
    rng = np.random.default_rng(5)
    return rng.integers(0, 256, size=(9, 24, 32), dtype=np.uint8), np.cumsum(rng.uniform(0.01, 0.1, 9))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_reads_identically_across_packages(tmp_path, store_data, writer):
    """A VOSTORE1 file written by either package is byte-identical to the
    other's and reads the same through both readers: stamps, slices, fancy
    indices, and iter_chunks with and without copies."""
    frames, stamps = store_data
    assert tstore.native_available()
    paths = {}
    for name, mod in (("port", tstore), ("reference", jstore)):
        paths[name] = str(tmp_path / f"{name}.vost")
        mod.write_store(paths[name], frames, stamps)
    with open(paths["port"], "rb") as f, open(paths["reference"], "rb") as g:
        assert f.read() == g.read()
    path = paths[writer]
    with tstore.StoreReader(path) as t, jstore.StoreReader(path) as j:
        assert (t.n, t.h, t.w) == (j.n, j.h, j.w) == frames.shape
        np.testing.assert_array_equal(t.timestamps(), j.timestamps())
        np.testing.assert_array_equal(t.timestamps(), stamps)
        tf, jf = t.frames(), j.frames()
        assert tf.shape == jf.shape and len(tf) == 9
        for key in (slice(2, 7), slice(None), slice(8, 20), [5, 0, 5, 8], np.array([3]), 4):
            np.testing.assert_array_equal(tf[key], jf[key])
            np.testing.assert_array_equal(tf[key], frames[key] if not isinstance(key, int) else frames[[key]])
        for copy in (True, False):
            got = [(s, np.array(c)) for s, c in t.iter_chunks(4, copy=copy)]
            want = [(s, np.array(c)) for s, c in j.iter_chunks(4, copy=copy)]
            assert [s for s, _ in got] == [s for s, _ in want] == [0, 4, 8]
            for (_, a), (_, b) in zip(got, want):
                np.testing.assert_array_equal(a, b)
        with pytest.raises(IndexError):
            t.read(7, 3)


def test_streamed_run_from_store_equals_ndarray(tmp_path):
    """The streaming path fed a StoreFrames gives the ndarray's results bit
    for bit (the backend fetches keyframes by fancy index)."""
    seq = tsynth.render_sequence(tsynth.SyntheticConfig(n_frames=7, width=96, height=72, n_landmarks=50))
    path = str(tmp_path / "s.vost")
    tstore.write_store(path, seq.frames, seq.timestamps)
    with tstore.StoreReader(path) as r:
        from_store = dataclasses.replace(seq, frames=r.frames())
        a = tpipe.run_experiment(from_store, TINY_CFG, None, 0, stream=True, checkpoint_chunk=4, device="cpu")
    b = tpipe.run_experiment(seq, TINY_CFG, None, 0, stream=True, checkpoint_chunk=4, device="cpu")
    _equal(a.trajectory, b.trajectory)
    np.testing.assert_array_equal(a.vo_abs, b.vo_abs)


# --------------------------------------------------------------------------
# The automatic switch
# --------------------------------------------------------------------------


class _Streamed(Exception):
    pass


class _InMemory(Exception):
    pass


@pytest.mark.parametrize("n,checkpoint,streams", [(345, None, False), (346, None, True), (345, "ck.npz", True)])
def test_stream_switch_at_2gib(monkeypatch, n, checkpoint, streams):
    """stream=None streams for a checkpoint path or for frames over 2 GiB as
    float32 (346 frames at 1440x1080 and up). The frames are a broadcast
    view and both branches are stopped at their first step, so no frame is
    ever materialised."""
    seq = tsynth.render_sequence(tsynth.SyntheticConfig(n_frames=2, width=64, height=48, n_landmarks=20))
    per_frame = {f: getattr(seq, f)[:1] for f in ("timestamps", "marker_corners", "marker_poses", "marker_present",
                                                  "marker_ids", "gt_poses")}
    big = dataclasses.replace(
        seq, frames=np.broadcast_to(np.zeros((1, 1080, 1440), np.uint8), (n, 1080, 1440)),
        camera=dataclasses.replace(seq.camera, width=1440, height=1080),
        **{f: np.broadcast_to(a, (n,) + a.shape[1:]) for f, a in per_frame.items()},
    )

    def streamed(*args, **kw):
        raise _Streamed(kw["chunk"])

    def in_memory(chunk):
        raise _InMemory

    monkeypatch.setattr(tpipe, "run_sequence_checkpointed", streamed)
    monkeypatch.setattr(tpipe, "make_preprocessor", lambda seq, dev: in_memory)
    with pytest.raises(_Streamed if streams else _InMemory) as e:
        tpipe.run_experiment(big, tvo.VOConfig(**HOLD), checkpoint_path=checkpoint, device="cpu")
    if streams:
        assert e.value.args == (256,)
