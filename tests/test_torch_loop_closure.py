"""The port's loop closure (backend/loop_closure.py) vs the JAX reference (CPU).

Both sides get the JAX package's own keyframe features (converted), so the
frontend is not under test: the global descriptors and similarities, the
shortlist, the retrieval counts, and find_loop_closures with the
reference's verification draws replayed. Keyframes come from the ground
truth of the small marker-gap loop in torch_backend_data.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from droplet_visual_odometry_tpu.backend import loop_closure as jlc
from droplet_visual_odometry_tpu.data import synthetic as jsynth
from droplet_visual_odometry_tpu.estimation.ransac import RansacConfig as JRansacConfig
from droplet_visual_odometry_tpu.estimation.vo import VOConfig as JVOConfig
from droplet_visual_odometry_tpu.frontend.features import detect_and_describe_batch as jdetect

from droplet_visual_odometry_tpu_torch import convert
from droplet_visual_odometry_tpu_torch.backend import loop_closure as tlc
from droplet_visual_odometry_tpu_torch.backend import refine as trefine
from droplet_visual_odometry_tpu_torch.frontend.orb import Features as TFeatures

from torch_backend_data import LC_KW, LOOP_CFG, REFINE_KW, jax_verify_draws, mask_marker_midrun

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def kf_data():
    """Keyframes of the loop chosen on its ground truth (with the marker-run
    ends), and the reference frontend's features on them as JAX arrays and
    as port tensors."""
    seq = mask_marker_midrun(jsynth.render_sequence(jsynth.SyntheticConfig(**LOOP_CFG)))
    gt = np.asarray(seq.marker_poses, np.float64)
    present = np.asarray(seq.marker_present)
    kf_idx = trefine.keyframe_indices(gt, np.full(len(gt) - 1, 300), present, trefine.keyframes.KeyframeConfig())
    jf = jdetect(jnp.asarray(seq.frames, jnp.float32)[jnp.asarray(kf_idx)], k=REFINE_KW["n_keypoints"])
    tf = TFeatures(
        torch.from_numpy(np.asarray(jf.xy)), torch.from_numpy(np.asarray(jf.score)),
        torch.from_numpy(np.asarray(jf.angle)), torch.from_numpy(np.asarray(jf.desc).view(np.int32).copy()),
        torch.from_numpy(np.asarray(jf.valid)),
    )
    return dict(
        kf_idx=kf_idx, jf=jf, tf=tf, abs=gt[kf_idx], corners=np.asarray(seq.marker_corners, np.float32)[kf_idx],
        present=present[kf_idx], bridges=trefine.bridge_pairs(present, kf_idx),
        K=np.asarray(seq.camera.K, np.float32), L=seq.real_marker_length,
    )


def test_global_descriptors_and_similarity_agree(kf_data):
    """Integer +-1 sums, then one division and one norm: descriptors to
    1e-6, similarities to 1e-5 (256-term f32 dot products). Float sets (the
    mean of L2-normalised vectors) pool the same way: here the keyframes'
    (x, y, score, angle) rows as 4-D vectors, to 1e-6."""
    jf, tf = kf_data["jf"], kf_data["tf"]
    g = tlc.global_descriptors(tf.desc, tf.valid)
    gj = jlc.global_descriptors(jf.desc, jf.valid)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=1e-6)
    np.testing.assert_allclose(tlc.global_similarity(g).numpy(), np.asarray(jlc.global_similarity(gj)), atol=1e-5)
    rows = np.concatenate([np.asarray(jf.xy), np.asarray(jf.score)[..., None], np.asarray(jf.angle)[..., None]], -1)
    gf = tlc.global_descriptors(torch.from_numpy(rows), tf.valid)
    np.testing.assert_allclose(gf.numpy(), np.asarray(jlc.global_descriptors(jnp.asarray(rows), jf.valid)), atol=1e-6)


def test_shortlist_and_retrieval_counts_agree(kf_data):
    """The global tier runs (more pairs than the shortlist) and keeps the
    same pairs; the mutual-best counts under the Hamming gate are exact, and
    the greedy selection picks the same candidates from them."""
    jf, tf = kf_data["jf"], kf_data["tf"]
    n_kf, cfg = len(kf_data["kf_idx"]), tlc.LoopClosureConfig(**LC_KW)
    assert len(tlc._pair_list(n_kf, cfg.min_gap)[0]) > cfg.shortlist
    ia, ib = tlc._shortlist_pairs(tf, n_kf, cfg.min_gap, cfg.shortlist)
    ja, jb = jlc._shortlist_pairs(jf, n_kf, cfg.min_gap, cfg.shortlist)
    assert len(ia) == cfg.shortlist
    assert sorted(zip(ia.tolist(), ib.tolist())) == sorted(zip(ja.tolist(), jb.tolist()))
    counts = tlc._retrieval_counts(tf.desc, tf.valid, ia, ib, cfg.match_max_distance).numpy()
    ref = np.asarray(jlc._retrieval_counts(jf.desc, jf.valid, jnp.asarray(ia), jnp.asarray(ib), cfg.match_max_distance))
    np.testing.assert_array_equal(counts, ref)
    assert (counts >= cfg.min_similarity).sum() > cfg.max_candidates
    assert len(tlc._select_candidates(ia, ib, counts, cfg)) == cfg.max_candidates


def test_find_loop_closures_replayed_draws_agree(kf_data):
    """With the reference's draws replayed and the reference op by op
    (jax.disable_jit: XLA's jit moves the 8-point solves, ROADMAP C), on the
    retrieved candidates plus the marker-gap bridge: the same edges (i, j,
    scale_ok), inliers within 2%, relative poses to 2e-3, rotation
    dispersions to 0.5 deg and direction dispersions to 2.5 deg (the max
    angle between restarts' unit translations on short-baseline pairs,
    where a direction moves by degrees under an f32-level change of E)."""
    d = kf_data
    args = (d["abs"], d["corners"], d["present"])
    extra = tuple(np.asarray(p) for p in d["bridges"])
    assert len(extra[0]) == 1
    # One inverse-iteration step per solve and one polish: fewer op-by-op
    # dispatches for the reference; the same schedule on both sides.
    jvo = JVOConfig(ransac=JRansacConfig(n_hypotheses=64, lo_hypotheses=16, hyp_eig_iters=1, lo_eig_iters=1,
                                         refine_iters=1))
    with jax.disable_jit():
        ref = jlc.find_loop_closures(d["jf"], *args, jnp.asarray(d["K"]), d["L"], jvo, jlc.LoopClosureConfig(**LC_KW),
                                     extra_pairs=extra)
    tvo = convert.vo_config_from_dict(dataclasses.asdict(jvo))
    out = tlc.find_loop_closures(d["tf"], *args, d["K"], d["L"], tvo, tlc.LoopClosureConfig(**LC_KW),
                                 extra_pairs=extra, draws=jax_verify_draws)
    # Without draws the port takes the reference's own (PRNGKey(0), made by utils/threefry.py): the same run.
    default = tlc.find_loop_closures(d["tf"], *args, d["K"], d["L"], tvo, tlc.LoopClosureConfig(**LC_KW),
                                     extra_pairs=extra)
    for a, b in zip(default, out):
        np.testing.assert_array_equal(a, b)
    for name in ("i", "j", "n_inliers", "rot_disp_deg", "dir_disp_deg"):
        print(f"{name}: port {getattr(out, name).tolist()} reference {getattr(ref, name).tolist()}")
    assert len(ref.i) >= 2
    np.testing.assert_array_equal(out.i, ref.i)
    np.testing.assert_array_equal(out.j, ref.j)
    np.testing.assert_array_equal(out.scale_ok, ref.scale_ok)
    assert np.all(np.abs(out.n_inliers - ref.n_inliers) <= 0.02 * ref.n_inliers)
    np.testing.assert_allclose(out.rel, ref.rel, atol=2e-3)
    np.testing.assert_allclose(out.rot_disp_deg, ref.rot_disp_deg, atol=0.5)
    np.testing.assert_allclose(out.dir_disp_deg, ref.dir_disp_deg, atol=2.5)


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_threefry_draws_equal_jax_random(seed):
    """utils/threefry.py against jax.random (threefry2x32, partitionable):
    PRNGKey, split, fold_in and float32 uniform bit for bit; the default
    verification draws equal the reference's for the run's seed."""
    from droplet_visual_odometry_tpu_torch.utils import threefry

    key, tkey = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(key).astype(np.int64))
    keys, tkeys = jax.random.split(key, 21), threefry.split(tkey, 21)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(keys).astype(np.int64))
    for data in (1, 2, 4099):
        np.testing.assert_array_equal(threefry.fold_in(tkeys[4], data).numpy(),
                                      np.asarray(jax.random.fold_in(keys[4], data)).astype(np.int64))
    want = np.stack([np.asarray(jax.random.uniform(k, (777,))) for k in keys[:6]])
    got = threefry.uniform(tkeys[:6], 777).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if seed == 0:
        n = 10
        cfg = dataclasses.replace(tlc.VOConfig().ransac, n_hypotheses=LC_KW["verify_hypotheses"],
                                  lo_hypotheses=LC_KW["verify_lo_hypotheses"])
        u_hyp, u_lo = tlc.reference_draws(n, cfg)
        ref_hyp, ref_lo = jax_verify_draws(n)
        np.testing.assert_array_equal(u_hyp.numpy(), ref_hyp.numpy())
        np.testing.assert_array_equal(u_lo.numpy(), ref_lo.numpy())
