"""The port's hand-written CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA GPU, carries the `cuda` marker and skips
without one (the card is looked for inside the `cuda_device` fixture, never
at import). This module imports torch and the port only, so it runs on a
GPU machine without JAX:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q --noconftest -o addopts= -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from droplet_visual_odometry_tpu_torch import pipeline
from droplet_visual_odometry_tpu_torch.data import synthetic
from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
from droplet_visual_odometry_tpu_torch.eval import metrics
from droplet_visual_odometry_tpu_torch.frontend import features, orb
from droplet_visual_odometry_tpu_torch.ops import cuda_describe, cuda_fast, cuda_match

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _images(n, h, w, seed, integer=True):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 60, size=(n, h, w)).astype(np.float32)
    for i in range(n):
        for y, x in rng.integers(4, [h - 8, w - 8], size=(h * w // 400, 2)):
            img[i, y : y + 4, x : x + 4] += 150.0
    return torch.from_numpy(np.round(img) if integer else img)


@pytest.mark.parametrize("h,w", [(96, 128), (101, 67), (470, 626), (1080, 1440)])
@pytest.mark.parametrize("thr,arc", [(20.0, 9), (10.0, 12), (5.0, 3), (20.0, 16), (20.0, 17)])
def test_fast_score_kernel_equals_plain(cuda_device, h, w, thr, arc):
    """Integer images: every excess sum is exact, so kernel == plain bit for
    bit; sizes off the 128x32 tile exercise the clamped halo and ragged edge,
    arc 9 the main path's instantiation and the others the generic one."""
    imgs = _images(3, h, w, seed=h + w).to(cuda_device)
    before = cuda_fast.LAUNCHES
    out = cuda_fast.fast_score_cuda(imgs, thr, arc)
    torch.cuda.synchronize()
    assert cuda_fast.LAUNCHES == before + 1
    torch.testing.assert_close(out, cuda_fast.fast_score_plain(imgs, thr, arc), rtol=0, atol=0)


def test_fast_score_kernel_float_images(cuda_device):
    """Float images: same f32 ops in the same neighbour order as the plain
    twin, so the corner set is equal and scores agree to 1e-3 at most."""
    imgs = _images(2, 130, 170, seed=5, integer=False).to(cuda_device)
    out = cuda_fast.fast_score_cuda(imgs, 20.0, 9)
    ref = cuda_fast.fast_score_plain(imgs, 20.0, 9)
    assert torch.equal(out > 0, ref > 0)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-3)


def test_fast_score_kernel_rejects_bad_inputs(cuda_device):
    with pytest.raises(ValueError):
        cuda_fast.fast_score_cuda(torch.zeros((2, 32, 32), dtype=torch.float64, device=cuda_device))
    with pytest.raises(ValueError):
        cuda_fast.fast_score_cuda(torch.zeros((2, 32, 64), device=cuda_device)[..., ::2])


def _describe_inputs(n, h, w, m, seed, cuda_device):
    """Rounded-blur-like images with bright squares, and origins at random
    places plus one on every edge and corner of the image."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, size=(n, h, w)).astype(np.float32)
    for i in range(n):
        for y, x in rng.integers(0, [h - 6, w - 6], size=(h * w // 200, 2)):
            imgs[i, y : y + 6, x : x + 6] = rng.uniform(0, 255)
    o = np.stack([rng.integers(0, n, m), rng.integers(0, h - 36, m), rng.integers(0, w - 36, m)], axis=1)
    o[:8, 1:] = [[0, 0], [h - 37, w - 37], [0, w - 37], [h - 37, 0], [0, 40], [h - 37, 40], [30, 0], [30, w - 37]]
    return (torch.from_numpy(imgs).to(cuda_device),
            torch.from_numpy(o.astype(np.int32)).to(cuda_device))


@pytest.mark.parametrize("integer", [True, False])
def test_describe_kernel_equals_plain(cuda_device, integer):
    """Words equal to the steering-matmul chain's, keypoints in all 30 angle
    bins, and angles equal (the same atan2f and IEEE steps on the card).
    Float images exercise the kernel's own rounding (rintf, half to even)."""
    imgs, origins = _describe_inputs(3, 150, 190, 3000, seed=int(integer), cuda_device=cuda_device)
    if integer:
        imgs = torch.round(imgs)
    before = cuda_describe.LAUNCHES
    words, ang = cuda_describe.describe_cuda(imgs, origins, check=True)
    torch.cuda.synchronize()
    assert cuda_describe.LAUNCHES == before + 1
    ref_words, ref_ang = cuda_describe.describe_plain(imgs, origins)
    bins = torch.remainder(torch.round(ref_ang / torch.full_like(ref_ang, 2 * np.pi) * 30), 30)
    assert len(torch.unique(bins)) == 30
    assert torch.equal(ang, ref_ang)
    assert torch.equal(words, ref_words)
    # Pairs whose two points coincide after clipping give bit 0, as their
    # steering column of zeros does.
    bits = ((words[:, :, None] >> torch.arange(32, device=cuda_device)) & 1).reshape(-1, 256).bool()
    pairs = torch.from_numpy(cuda_describe._PAIRS).to(cuda_device)[bins.long()]
    coincide = pairs[..., 0] == pairs[..., 1]
    assert coincide.any() and not bits[coincide].any()


def test_describe_kernel_flat_and_ramp_patches(cuda_device):
    """A flat patch makes every test false and its angle 0; a ramp along x
    has angle 0 and sets exactly the bin-0 bits whose p2 lies right of p1."""
    n, h, w = 1, 64, 64
    flat = torch.full((n, h, w), 77.0, device=cuda_device)
    origins = torch.tensor([[0, 10, 12]], dtype=torch.int32, device=cuda_device)
    words, ang = cuda_describe.describe_cuda(flat, origins)
    assert not words.any() and float(ang[0]) == 0.0
    ramp = torch.arange(w, dtype=torch.float32, device=cuda_device).expand(n, h, w).contiguous()
    words, ang = cuda_describe.describe_cuda(ramp, origins)
    ref_words, ref_ang = cuda_describe.describe_plain(ramp, origins)
    assert torch.equal(words, ref_words) and torch.equal(ang, ref_ang)
    pairs = torch.from_numpy(cuda_describe._PAIRS[0].astype(np.int64))
    want = cuda_describe.pack_bits((pairs[:, 1] % 37 > pairs[:, 0] % 37)[None]).to(cuda_device)
    assert float(ang[0]) == 0.0 and torch.equal(words, want)


def test_describe_kernel_checks_inputs(cuda_device):
    imgs = torch.zeros((2, 64, 64), device=cuda_device)
    with pytest.raises(ValueError, match="out of range"):
        cuda_describe.describe_cuda(imgs, torch.tensor([[0, 28, 0]], dtype=torch.int32, device=cuda_device), check=True)
    with pytest.raises(ValueError, match="out of range"):
        cuda_describe.describe_cuda(imgs, torch.tensor([[2, 0, 0]], dtype=torch.int32, device=cuda_device), check=True)
    with pytest.raises(ValueError):
        cuda_describe.describe_cuda(imgs, torch.zeros((4, 3), dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError):
        cuda_describe.describe_cuda(imgs.double(), torch.zeros((4, 3), dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        cuda_describe.describe_cuda(torch.zeros((2, 30, 64), device=cuda_device),
                                    torch.zeros((4, 3), dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        cuda_describe.describe_cuda(imgs, torch.zeros((4, 3), dtype=torch.int32))
    words, ang = cuda_describe.describe_cuda(imgs, torch.zeros((0, 3), dtype=torch.int32, device=cuda_device))
    assert words.shape == (0, 8) and ang.shape == (0,)


def _descriptors(p, k, seed, ties):
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 2**32, size=(p, k, 8), dtype=np.uint32)
    if ties:  # repeated rows, distances from one word only: equal minima everywhere
        desc = desc[:, rng.integers(0, max(k // 8, 1), size=k)]
        desc[..., 1:] = 0
    valid = rng.uniform(size=(p, k)) > 0.2
    return torch.from_numpy(desc.view(np.int32).copy()), torch.from_numpy(valid)


def _match_args(da, db, va, vb, device):
    return [t.to(device) for t in (da, db, va, vb)]


@pytest.mark.parametrize(
    "p,k,ties",
    [(3, 100, True), (3, 512, False), (3, 512, True), (3, 2048, False), (3, 2048, True),
     (3, 1, False), (3, 100, False), (3, 4096, False), (3, 4096, True),
     (1, 512, True), (64, 512, False), (64, 512, True)],
)
def test_match_reductions_kernel_equals_plain(cuda_device, p, k, ties):
    """Integer distances and lowest-index ties on both sides: exact equality
    of d1, i1, d2 and col_best (a min over packed keys has no order). K = 1
    is a single column, K = 4096 the largest (eight row tiles per cluster
    rank), P = 64 a loop-closure batch."""
    da, va = _descriptors(p, k, seed=k, ties=ties)
    db, vb = _descriptors(p, k, seed=k + 1, ties=ties)
    args = _match_args(da, db, va, vb, cuda_device)
    before = cuda_match.LAUNCHES
    out = cuda_match.match_reductions_cuda(*args)
    torch.cuda.synchronize()
    assert cuda_match.LAUNCHES == before + 1
    for got, want in zip(out, cuda_match.match_reductions_plain(*args)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("k", [100, 512])
def test_match_reductions_kernel_all_invalid_lines(cuda_device, k):
    """Pair 0 has no valid row, pair 1 no valid column, pair 2 neither: every
    row there reports d1 = d2 = BIG and i1 = 0, and every column col_best = 0,
    as the plain twin's argmin over an all-512 line gives."""
    da, va = _descriptors(4, k, seed=7 * k, ties=False)
    db, vb = _descriptors(4, k, seed=7 * k + 1, ties=False)
    va[0] = False
    vb[1] = False
    va[2] = False
    vb[2] = False
    args = _match_args(da, db, va, vb, cuda_device)
    d1, i1, d2, cb = cuda_match.match_reductions_cuda(*args)
    for got, want in zip((d1, i1, d2, cb), cuda_match.match_reductions_plain(*args)):
        assert torch.equal(got, want)
    for q in range(3):
        assert bool((d1[q] == cuda_match.BIG).all()) and bool((d2[q] == cuda_match.BIG).all())
        assert not i1[q].any() and not cb[q].any()
    assert bool((d1[3] < cuda_match.BIG).any())


@pytest.mark.parametrize("p,k", [(2, 512), (1, 4096)])
def test_match_reductions_kernel_ties_across_merges(cuda_device, p, k):
    """Equal descriptors on either side of every boundary the kernel merges
    across: m16 tiles (15/16), row halves and lane groups (31/32), 64-row
    tiles and column slices of the cluster ranks (63/64, 511/512 at K =
    4096), n-tiles and column quarters (7/8), the B swizzle (3/4). The lower
    index must win each tie in i1 and col_best, and d2 must see the tie."""
    rng = np.random.default_rng(k + p)
    da = rng.integers(0, 2**32, size=(p, k, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, size=(p, k, 8), dtype=np.uint32)
    pairs = [(lo, lo + 1) for lo in (3, 7, 15, 31, 63, 127, 511) if lo + 1 < k]
    for lo, hi in pairs:
        db[:, hi] = db[:, lo]  # equal columns
        da[:, lo] = db[:, lo]  # row lo is at distance 0 from both
        da[:, hi] = db[:, lo]  # and so is row hi: equal rows
    valid = np.ones((p, k), dtype=bool)
    to_t = lambda d: torch.from_numpy(d.view(np.int32).copy())
    args = _match_args(to_t(da), to_t(db), torch.from_numpy(valid), torch.from_numpy(valid), cuda_device)
    d1, i1, d2, cb = cuda_match.match_reductions_cuda(*args)
    for got, want in zip((d1, i1, d2, cb), cuda_match.match_reductions_plain(*args)):
        assert torch.equal(got, want)
    for lo, hi in pairs:
        assert bool((i1[:, lo] == lo).all()) and bool((i1[:, hi] == lo).all())
        assert bool((cb[:, lo] == lo).all()) and bool((cb[:, hi] == lo).all())
        assert bool((d1[:, lo] == 0).all()) and bool((d2[:, lo] == 0).all())


def test_match_reductions_one_kernel_no_memset(cuda_device):
    """One call is one device operation: the match kernel, no memset and no
    second kernel."""
    from torch.profiler import ProfilerActivity, profile

    da, va = _descriptors(23, 512, seed=3, ties=False)
    db, vb = _descriptors(23, 512, seed=4, ties=False)
    args = _match_args(da, db, va, vb, cuda_device)
    cuda_match.match_reductions_cuda(*args)  # builds and warms up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cuda_match.match_reductions_cuda(*args)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = [e.key for e in dev]
    assert sum(e.count for e in dev) == 1, names
    assert "match_kernel" in names[0] and not any("memset" in n.lower() for n in names), names


def test_slice_on_cuda_launches_every_kernel(cuda_device):
    """run_experiment on the card goes through all three kernels (one FAST
    and one describe launch per pyramid level, one batched match) and agrees
    with the port's CPU run: level 0 is exact, the bf16 resize sums in
    another order on the card, so match counts may move by a few in total
    (2% bound). The ATE is held to 3 cm: the port's CPU runs of this
    sequence give 7-13 mm over RANSAC seeds 0-2, and the card draws other
    random samples."""
    seq = synthetic.render_sequence(synthetic.SyntheticConfig(n_frames=8, width=640, height=480, n_landmarks=350))
    cpu = pipeline.run_experiment(seq, VOConfig(), device="cpu")
    for mod in (cuda_fast, cuda_describe, cuda_match):
        mod.LAUNCHES = 0
    gpu = pipeline.run_experiment(seq, VOConfig(), device=cuda_device)
    assert (cuda_fast.LAUNCHES, cuda_describe.LAUNCHES, cuda_match.LAUNCHES) == (4, 4, 1)
    assert np.isfinite(gpu.vo_abs).all() and gpu.trajectory.ok.all()
    dev = np.abs(gpu.trajectory.n_matches - cpu.trajectory.n_matches).sum()
    assert dev <= 0.02 * cpu.trajectory.n_matches.sum()
    assert gpu.ate.rmse < 0.03


def test_feature_layouts_on_cuda(cuda_device):
    """detect_and_describe_batch keeps the reference's layouts on the card."""
    imgs = _images(2, 240, 320, seed=9).to(cuda_device)
    f = features.detect_and_describe_batch(imgs, k=256)
    assert f.xy.shape == (2, 256, 2) and f.desc.shape == (2, 256, orb.N_WORDS)
    assert f.desc.dtype == torch.int32 and f.valid.dtype == torch.bool and f.xy.device.type == "cuda"


@pytest.mark.parametrize("p", [64, 128])
def test_match_at_loop_closure_shapes(cuda_device, p):
    """The match at loop closure's shapes, K = 1024: P = 64 is the retrieval
    shortlist, P = 64 or 128 the verification batch (restarts x slots).
    Half of each B set are near copies of A rows (a few bits flipped), so
    the Hamming gate at 64 keeps some matches and drops others: the
    reductions and the gated crosscheck matches equal the plain twin's."""
    from droplet_visual_odometry_tpu_torch.frontend import matcher

    rng = np.random.default_rng(p)
    da = rng.integers(0, 2**32, size=(p, 1024, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, size=(p, 1024, 8), dtype=np.uint32)
    rows = rng.permutation(1024)[:512]
    flips = rng.integers(0, 2**32, size=(p, 512, 8), dtype=np.uint32) & rng.integers(0, 2**32, size=(p, 512, 8),
                                                                                      dtype=np.uint32)
    db[:, rows] = da[:, rows] ^ (flips & (flips >> 3) & (flips >> 7))
    valid = rng.uniform(size=(2, p, 1024)) > 0.1
    to_t = lambda d: torch.from_numpy(d.view(np.int32).copy())
    cpu = [to_t(da), to_t(db), torch.from_numpy(valid[0]), torch.from_numpy(valid[1])]
    gpu = [t.to(cuda_device) for t in cpu]
    before = cuda_match.LAUNCHES
    for got, want in zip(cuda_match.match_reductions_cuda(*gpu), cuda_match.match_reductions_plain(*gpu)):
        assert torch.equal(got, want)
    m_gpu = matcher.match(*gpu, mode="crosscheck", max_distance=64)
    m_cpu = matcher.match(*cpu, mode="crosscheck", max_distance=64)
    assert cuda_match.LAUNCHES == before + 2
    for got, want in zip(m_gpu, m_cpu):
        assert torch.equal(got.cpu(), want)
    n = int(m_cpu.valid.sum())
    assert 0 < n < int((m_cpu.distance < cuda_match.BIG).sum())


def test_pose_graph_trajectory_on_cuda(cuda_device):
    """One pose_graph_trajectory call on the card launches FAST and describe
    once per pyramid level on the keyframe stack and the match twice
    (retrieval counts, then verification), and with the same verification
    draws on both devices finds the CPU run's keyframes, bridge and loop
    pairs. The poses are held by their ATE, not element by element: on pairs
    whose translation direction is ill-conditioned (restarts far apart) the
    card's f32 verification picks another restart than the CPU's, which
    moves those scale-free edges' unit translations and their weights and
    shifts refined poses by centimetres. So the card's ATE is held to
    the CPU run's within 0.037 m (test_run_experiment_pose_graph_agrees's
    tolerance, twice the reference's seed-to-seed spread) and must beat the
    raw VO chain's by a quarter."""
    from droplet_visual_odometry_tpu_torch.backend import loop_closure, refine
    from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig

    seq = synthetic.render_sequence(synthetic.SyntheticConfig(
        n_frames=32, width=448, height=336, n_landmarks=350, orbit_sweep=0.6, dolly=0.5, loop=True, noise_std=1.5))
    seq.marker_present[6:-6] = False
    seq.marker_corners[6:-6] = np.nan
    vo = VOConfig(scale_mode="hold", ransac=RansacConfig(n_hypotheses=128, lo_hypotheses=32))
    cfg = refine.PoseGraphRefineConfig(n_keypoints=512, lc=loop_closure.LoopClosureConfig(min_gap=5, min_inliers=30))
    base = pipeline.run_experiment(seq, vo, device="cpu")
    g = torch.Generator().manual_seed(0)
    u = {}

    def draws(n):
        if n not in u:
            u[n] = (torch.rand((n, 1024 * 8), generator=g), torch.rand((n, 2, 256 * 14), generator=g))
        return u[n]

    args = (base.vo_abs, base.trajectory.n_inliers, pipeline.effective_marker_corners(seq, seq.camera.K),
            seq.marker_present, seq.camera.K, seq.real_marker_length, vo, cfg)
    frames = torch.from_numpy(seq.frames).float()
    cpu, cpu_info = refine.pose_graph_trajectory(frames, *args, pair_scale_ok=base.trajectory.scale_ok, draws=draws)
    for mod in (cuda_fast, cuda_describe, cuda_match):
        mod.LAUNCHES = 0
    gpu, gpu_info = refine.pose_graph_trajectory(frames.to(cuda_device), *args, pair_scale_ok=base.trajectory.scale_ok,
                                                 draws=draws)
    assert (cuda_fast.LAUNCHES, cuda_describe.LAUNCHES, cuda_match.LAUNCHES) == (4, 4, 2)
    for key in ("n_keyframes", "n_bridge_pairs", "loop_pairs"):
        assert gpu_info[key] == cpu_info[key], key
    assert gpu_info["n_loop_edges"] >= 1 and gpu_info["pg_final_cost"] < gpu_info["pg_initial_cost"]
    gt_cam = np.linalg.inv(np.asarray(seq.marker_poses, np.float64))
    ate = lambda poses: metrics.ate(gt_cam, np.linalg.inv(poses), align="none").rmse
    assert np.isfinite(gpu).all() and gpu.shape == cpu.shape
    assert abs(ate(gpu) - ate(cpu)) < 0.037 and ate(gpu) < 0.75 * ate(base.vo_abs)
