"""The reference's RANSAC draws on every VO path of the port vs jax.random (CPU).

Each draw site derives its keys as the JAX package does (utils/threefry.py:
split, fold_in, uniform and ransac_uniforms, bit for bit), and each VO entry
point run with its default draws equals the same call with the JAX
package's uniforms injected, bit for bit: run_sequence,
run_sequence_checkpointed, an OnlineVO push (also across its ring's
refills) and shard_pair_vo. So a seed gives the JAX package's run.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from droplet_visual_odometry_tpu_torch import groundtruth as tgt
from droplet_visual_odometry_tpu_torch import stream
from droplet_visual_odometry_tpu_torch.core import se3 as tse3
from droplet_visual_odometry_tpu_torch.data import synthetic as tsynth
from droplet_visual_odometry_tpu_torch.estimation import vo as tvo
from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig
from droplet_visual_odometry_tpu_torch.parallel import launch, sharding
from droplet_visual_odometry_tpu_torch.stream import OnlineVO
from droplet_visual_odometry_tpu_torch.utils import checkpoint as tck
from droplet_visual_odometry_tpu_torch.utils import threefry

torch.set_num_threads(2)

CFG = RansacConfig()
N_HYP, N_LO = CFG.n_hypotheses * CFG.sample_size, CFG.lo_hypotheses * CFG.lo_sample_size
SEQ_CFG = dict(n_frames=6, width=448, height=336, n_landmarks=350)


def _words(jkey) -> np.ndarray:
    return np.asarray(jkey).astype(np.int64)


def jax_uniforms(jkeys, rounds: int = 1):
    """The reference's draws of one ransac_essential call per key (ransac.py:88,
    188, 205) as the port's injected (u_hyp (n, B*8), u_lo (n, rounds, L*14))."""
    u_hyp = np.stack([np.asarray(jax.random.uniform(k, (N_HYP,))) for k in jkeys])
    u_lo = np.stack([np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(k, r), (N_LO,)))
                               for r in range(1, rounds + 1)]) for k in jkeys])
    return torch.from_numpy(u_hyp), torch.from_numpy(u_lo)


# Each site's key derivation in the JAX package (file:line) and in the port, on
# seed `s`: (jax's words, the port's words).
SITES = {
    # vo.py:189, split(key, N-1) per pair.
    "pair_split": lambda s: (_words(jax.random.split(jax.random.PRNGKey(s), 23)),
                             threefry.split(threefry.prng_key(s), 23).numpy()),
    # ransac.py:88, uniform(key, B*8) for the hypotheses.
    "hypotheses": lambda s: (jax_uniforms(jax.random.split(jax.random.PRNGKey(s), 5))[0].numpy(),
                             threefry.ransac_uniforms(threefry.split(threefry.prng_key(s), 5), CFG)[0].numpy()),
    # ransac.py:188, uniform(fold_in(key, 1), L*14), the fused LO round.
    "lo_round_1": lambda s: (jax_uniforms(jax.random.split(jax.random.PRNGKey(s), 5))[1].numpy(),
                             threefry.ransac_uniforms(threefry.split(threefry.prng_key(s), 5), CFG)[1].numpy()),
    # ransac.py:205, fold_in(key, 1) and fold_in(key, 2), the two sequential LO rounds.
    "lo_rounds_1_2": lambda s: (
        jax_uniforms(jax.random.split(jax.random.PRNGKey(s), 5), rounds=2)[1].numpy(),
        threefry.ransac_uniforms(threefry.split(threefry.prng_key(s), 5),
                                 dataclasses.replace(CFG, fused_lo_polish=False))[1].numpy()),
    # checkpoint.py:127, fold_in(key, start) per chunk.
    "chunk_start": lambda s: (np.stack([_words(jax.random.fold_in(jax.random.PRNGKey(s), st)) for st in (1, 257, 25_057)]),
                              np.stack([threefry.fold_in(threefry.prng_key(s), st).numpy() for st in (1, 257, 25_057)])),
    # stream.py:112, fold_in(key, step) per push, the step a host int or the graph's device counter.
    "push_step": lambda s: (np.stack([_words(jax.random.fold_in(jax.random.PRNGKey(s), np.uint32(st))) for st in (1, 2, 70)] * 2),
                            np.stack([threefry.fold_in(threefry.prng_key(s), st).numpy() for st in (1, 2, 70)]
                                     + [threefry.fold_in(threefry.prng_key(s), torch.tensor(st)).numpy() for st in (1, 2, 70)])),
    # sharding.py:83, split(key, B) per batch.
    "batch_split": lambda s: (_words(jax.random.split(jax.random.PRNGKey(s), 32)),
                              threefry.split(threefry.prng_key(s), 32).numpy()),
    # pipeline.py:317, fold_in(key, i) per dumped pair, one key per pair.
    "dump_pair": lambda s: (np.stack([_words(jax.random.fold_in(jax.random.PRNGKey(s), i)) for i in (0, 5, 10)]),
                            np.stack([threefry.fold_in(threefry.prng_key(s), i).numpy() for i in (0, 5, 10)])),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_draw_site_equals_jax_random(site):
    """Each site's keys and uniforms bit for bit against jax.random, on
    seeds 0, 3 and 2**32 - 1 (the largest PRNGKey word)."""
    for seed in (0, 3, 2**32 - 1):
        want, got = SITES[site](seed)
        assert got.shape == want.shape, (site, seed)
        np.testing.assert_array_equal(got, want, err_msg=f"{site} seed {seed}")


def test_prng_key_takes_the_jax_seed_range():
    """prng_key(s) is PRNGKey(s)'s words for 0 <= s < 2**32 and raises outside."""
    for seed in (0, 1, 2**31, 2**32 - 1):
        np.testing.assert_array_equal(threefry.prng_key(seed).numpy(), _words(jax.random.PRNGKey(seed)))
    for seed in (-1, 2**32):
        with pytest.raises(ValueError):
            threefry.prng_key(seed)


# --------------------------------------------------------------------------
# Each VO path with its default draws equals the JAX package's draws injected
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def seq():
    return tsynth.render_sequence(tsynth.SyntheticConfig(**SEQ_CFG))


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _run_sequence(seq):
    args = (torch.from_numpy(seq.frames).float(), seq.marker_corners, seq.marker_present, seq.marker_poses[0],
            seq.camera.K, seq.real_marker_length, tvo.VOConfig())
    u_hyp, u_lo = jax_uniforms(jax.random.split(jax.random.PRNGKey(7), len(seq) - 1))
    return tvo.run_sequence(*args, seed=7), tvo.run_sequence(*args, u_hyp=u_hyp, u_lo=u_lo)


def _checkpointed(seq):
    args = (seq.frames, np.asarray(seq.marker_corners, np.float32), seq.marker_present,
            np.asarray(seq.marker_poses[0], np.float32), np.asarray(seq.camera.K, np.float32), seq.real_marker_length,
            tvo.VOConfig(scale_mode="hold"))

    def draws(start, n_pairs):  # checkpoint.py:127 then vo.py:189
        return jax_uniforms(jax.random.split(jax.random.fold_in(jax.random.PRNGKey(7), start), n_pairs))

    kw = dict(path=None, chunk=3, device="cpu")  # 5 pairs: 3, then 2 padded to 3
    return tck.run_sequence_checkpointed(*args, seed=7, **kw), tck.run_sequence_checkpointed(*args, draws=draws, **kw)


def _pushes(seq):
    def dets(i):
        t, q = tse3.to_translation_quaternion(torch.from_numpy(np.asarray(seq.marker_poses[i], np.float32)))
        return tgt.detections_from_arrays(np.asarray([[0]], np.int32), t.numpy()[None, None], q.numpy()[None, None],
                                          np.asarray(seq.marker_corners[i])[None, None])

    def draws(step):  # stream.py:112
        u_hyp, u_lo = jax_uniforms([jax.random.fold_in(jax.random.PRNGKey(7), np.uint32(step))])
        return u_hyp, u_lo[:, 0]

    out = []
    for kw in (dict(seed=7), dict(draws=draws)):
        vo = OnlineVO(K=np.asarray(seq.camera.K), real_marker_length=seq.real_marker_length,
                      gt_cfg=tgt.GroundTruthConfig(use_base_link=False), device="cpu", **kw)
        rs = [vo.push(seq.timestamps[i], seq.frames[i], dets(i)) for i in range(len(seq))]
        assert all(r.ok for r in rs[1:])
        out.append([np.stack([r.rel for r in rs]), np.stack([r.pose for r in rs]), [r.n_inliers for r in rs]])
    return out


def _shard_pair_vo(seq):
    mesh = launch.global_mesh(device="cpu")
    assert (mesh.size, mesh.group) == (1, None)
    b = len(seq) - 1
    args = (seq.frames[:-1], seq.frames[1:], np.nan_to_num(seq.marker_corners[:-1]), np.nan_to_num(seq.marker_corners[1:]),
            seq.marker_present[:-1] & seq.marker_present[1:], seq.camera.K, seq.real_marker_length, tvo.VOConfig())
    u_hyp, u_lo = jax_uniforms(jax.random.split(jax.random.PRNGKey(7), b))  # sharding.py:83
    return [sharding.shard_pair_vo(mesh, *args, seed=7)], [sharding.shard_pair_vo(mesh, *args, u_hyp=u_hyp, u_lo=u_lo)]


def _pushes_across_ring_blocks(seq):
    """OnlineVO's ring at 2 pushes a block: the 5 armed pushes refill it at steps 3 and 5."""
    with mock.patch.object(stream, "DRAW_BLOCK", 2):
        return _pushes(seq)


PATHS = {"run_sequence": _run_sequence, "run_sequence_checkpointed": _checkpointed, "online_push": _pushes,
         "online_push_ring_refill": _pushes_across_ring_blocks, "shard_pair_vo": _shard_pair_vo}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_default_draws_equal_injected_jax_draws(seq, path):
    """The path run on seed 7 with its default draws equals, bit for bit,
    the same call with the JAX package's uniforms for seed 7 injected."""
    default, injected = PATHS[path](seq)
    _equal(default, injected)

