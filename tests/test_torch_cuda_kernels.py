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


def _count_from_zero():
    """Set the kernels' launch counters to 0 and drop every captured program
    (utils/graphs.py), so the run that follows captures each program it
    runs: a captured program's kernels tick twice (its warm-up and its
    capture, none on a replay), a kernel run op by op once a launch."""
    from droplet_visual_odometry_tpu_torch.utils import graphs

    graphs.clear()
    for mod in (cuda_fast, cuda_describe, cuda_match):
        mod.LAUNCHES = 0


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
     (1, 512, True), (64, 512, False), (64, 512, True), (3, 1000, False), (3, 1000, True), (400, 1000, False)],
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
    and one describe launch per pyramid level, one batched match, in
    run_sequence's program: captured once, so each ticks twice) and agrees
    with the port's CPU run: level 0 is exact, the bf16 resize sums in
    another order on the card, so match counts may move by a few in total
    (2% bound). The ATE is held to 3 cm: the port's CPU runs of this
    sequence give 7-13 mm over RANSAC seeds 0-2, and the card draws other
    random samples."""
    seq = synthetic.render_sequence(synthetic.SyntheticConfig(n_frames=8, width=640, height=480, n_landmarks=350))
    cpu = pipeline.run_experiment(seq, VOConfig(), device="cpu")
    _count_from_zero()
    gpu = pipeline.run_experiment(seq, VOConfig(), device=cuda_device)
    assert (cuda_fast.LAUNCHES, cuda_describe.LAUNCHES, cuda_match.LAUNCHES) == (8, 8, 2)  # run_sequence captured
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


@pytest.mark.parametrize("batch", [False, True])
def test_detect_and_describe_public_functions_on_cuda(cuda_device, batch):
    """fast.detect and orb.describe launch their kernels on a CUDA tensor
    (one launch each) and equal the plain twins on the same card: keypoints,
    scores and validity bit for bit, descriptor words and angles equal."""
    from droplet_visual_odometry_tpu_torch.frontend import fast, filters

    imgs = _images(2, 480, 640, seed=13).to(cuda_device)
    img = imgs if batch else imgs[0]
    before = (cuda_fast.LAUNCHES, cuda_describe.LAUNCHES)
    kps = fast.detect(img, k=512)
    torch.cuda.synchronize()
    assert cuda_fast.LAUNCHES == before[0] + 1
    score = cuda_fast.fast_score_plain(img, 20.0, 9)
    ref = fast.select_topk_rows(fast.nms3x3(score), 512)
    for got, want in zip(kps, ref):
        assert torch.equal(got, want)
    blur = filters.gaussian_blur(imgs[0], 2.0, 4, compute_dtype=torch.bfloat16).contiguous()
    one = fast.Keypoints(*(f[0] for f in kps)) if batch else kps
    words, ang = orb.describe(blur, one)
    torch.cuda.synchronize()
    assert cuda_describe.LAUNCHES == before[1] + 1
    assert words.shape == (512, orb.N_WORDS) and words.device.type == "cuda"
    ref_words, ref_ang = cuda_describe.describe_plain(blur[None], orb.patch_origins(one.xy[None], 480, 640))
    assert torch.equal(words, ref_words) and torch.equal(ang, ref_ang)


# The euroc_mav_752 configuration's VO pyramid: 752x480 at 8 levels of 1.2,
# down to 210x134, with K = 1000 split over the levels.
EUROC_LEVELS = list(zip(features.level_shapes(480, 752, 8, 1.2), features.level_budgets(1000, 8, 1.2)))


@pytest.mark.parametrize("hw,k", EUROC_LEVELS)
def test_kernels_at_the_euroc_pyramid_levels(cuda_device, hw, k):
    """FAST and the fused describe at each level of the 8-level pyramid,
    with that level's keypoint budget, against their plain twins on the
    same card: scores bit for bit, descriptor words and angles equal."""
    from droplet_visual_odometry_tpu_torch.frontend import fast, filters

    h, w = hw
    imgs = _images(3, h, w, seed=h * w).to(cuda_device)
    score = cuda_fast.fast_score_cuda(imgs, 20.0, 9)
    assert torch.equal(score, cuda_fast.fast_score_plain(imgs, 20.0, 9))
    kps = fast.select_topk_rows(fast.nms3x3(score), k)
    blur = filters.gaussian_blur(imgs, 2.0, 4, compute_dtype=torch.bfloat16).contiguous()
    words, ang = orb.describe_batch(blur, kps.xy)
    ref_words, ref_ang = cuda_describe.describe_plain(blur.to(torch.float32), orb.patch_origins(kps.xy, h, w))
    assert torch.equal(words.reshape(-1, orb.N_WORDS), ref_words) and torch.equal(ang.reshape(-1), ref_ang)


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
    once per pyramid level on the keyframe stack and the match for the
    retrieval counts, and captures verification (its match ticks twice:
    warm-up and capture), and with the same verification
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
    _count_from_zero()
    gpu, gpu_info = refine.pose_graph_trajectory(frames.to(cuda_device), *args, pair_scale_ok=base.trajectory.scale_ok,
                                                 draws=draws)
    # The keyframe stack and retrieval op by op, verification captured.
    assert (cuda_fast.LAUNCHES, cuda_describe.LAUNCHES, cuda_match.LAUNCHES) == (4, 4, 3)
    for key in ("n_keyframes", "n_bridge_pairs", "loop_pairs"):
        assert gpu_info[key] == cpu_info[key], key
    assert gpu_info["n_loop_edges"] >= 1 and gpu_info["pg_final_cost"] < gpu_info["pg_initial_cost"]
    gt_cam = np.linalg.inv(np.asarray(seq.marker_poses, np.float64))
    ate = lambda poses: metrics.ate(gt_cam, np.linalg.inv(poses), align="none").rmse
    assert np.isfinite(gpu).all() and gpu.shape == cpu.shape
    assert abs(ate(gpu) - ate(cpu)) < 0.037 and ate(gpu) < 0.75 * ate(base.vo_abs)


def _ba_window(seed=0, W=6, L=120, noise_px=0.5):
    """A perturbed BA window (test_backend.py's make_ba_problem, in torch)."""
    from droplet_visual_odometry_tpu_torch.backend import ba
    from droplet_visual_odometry_tpu_torch.core import se3

    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -1.5, 4], [2, 1.5, 9], size=(L, 3)).astype(np.float32)
    xi = np.concatenate([np.stack([0.25 * np.arange(W), 0.02 * np.arange(W), np.zeros(W)], 1)
                         + rng.normal(scale=0.02, size=(W, 3)), rng.normal(scale=0.03, size=(W, 3))], 1)
    poses = se3.se3_exp(torch.from_numpy(xi.astype(np.float32)))
    K = torch.tensor([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]])
    p, uv = ba._project(poses, torch.from_numpy(pts), K)
    uv = uv + torch.from_numpy(rng.normal(scale=noise_px, size=tuple(uv.shape)).astype(np.float32))
    inside = (p[..., 2] > 0.1) & (uv[..., 0] > 0) & (uv[..., 0] < 640) & (uv[..., 1] > 0) & (uv[..., 1] < 480)
    mask = inside & torch.from_numpy(rng.uniform(size=tuple(inside.shape)) > 0.1)
    dxi = rng.normal(scale=0.02, size=(W, 6)).astype(np.float32)
    dxi[0] = 0
    poses0 = se3.se3_exp(torch.from_numpy(dxi)) @ poses
    pts0 = torch.from_numpy(pts + rng.normal(scale=0.05, size=pts.shape).astype(np.float32))
    return ba.BAWindow(poses=poses0, points=pts0, obs_uv=uv, obs_mask=mask, K=K)


@pytest.mark.parametrize("seed,n_fixed", [(0, 1), (1, 2), (2, 2)])
def test_run_ba_on_cuda(cuda_device, seed, n_fixed):
    """run_ba on the card (cuSOLVER for the dense camera system) against the
    CPU (LAPACK): costs to 1e-3 relative, poses to 1e-3 and points to 5e-3 m,
    the tolerances the CPU port is held to against the JAX package."""
    from droplet_visual_odometry_tpu_torch.backend import ba

    w = _ba_window(seed)
    cfg = ba.BAConfig(n_fixed=n_fixed)
    cpu = ba.run_ba(w, cfg)
    gpu = ba.run_ba(ba.BAWindow(*(t.to(cuda_device) for t in w)), cfg)
    assert float(gpu.final_cost) < float(gpu.initial_cost)
    for f in ("initial_cost", "final_cost", "rms_px"):
        np.testing.assert_allclose(float(getattr(gpu, f)), float(getattr(cpu, f)), rtol=1e-3)
    np.testing.assert_allclose(gpu.poses.cpu().numpy(), cpu.poses.numpy(), atol=1e-3)
    np.testing.assert_allclose(gpu.points.cpu().numpy(), cpu.points.numpy(), atol=5e-3)
    assert torch.equal(gpu.poses[:n_fixed].cpu(), w.poses[:n_fixed])


def _loop_sequence():
    seq = synthetic.render_sequence(synthetic.SyntheticConfig(
        n_frames=32, width=448, height=336, n_landmarks=350, orbit_sweep=0.6, dolly=0.5, loop=True, noise_std=1.5))
    seq.marker_present[6:-6] = False
    seq.marker_corners[6:-6] = np.nan
    return seq


def test_streamed_run_on_cuda_matches_in_memory(cuda_device, tmp_path):
    """A streamed run on the card (chunks of 8 pairs through the page-locked
    buffer, the last chunk padded) against the in-memory run of the same
    frames: one program for every chunk (FAST and describe 4 launches a
    replay, ticking at its warm-up and capture only), match counts within 2%
    in total (the bf16 resize matmuls may sum in another order at another
    batch size), and a run interrupted after its first chunk and resumed
    equal to the uninterrupted streamed run bit for bit."""
    from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig
    from droplet_visual_odometry_tpu_torch.utils import checkpoint

    seq = _loop_sequence()
    vo = VOConfig(scale_mode="hold", ransac=RansacConfig(n_hypotheses=128, lo_hypotheses=32))
    _count_from_zero()
    streamed = pipeline.run_experiment(seq, vo, None, 0, stream=True, checkpoint_chunk=8)
    # Every chunk (the padded last one too) replays one captured program.
    assert (cuda_fast.LAUNCHES, cuda_describe.LAUNCHES, cuda_match.LAUNCHES) == (8, 8, 2)
    mem = pipeline.run_experiment(seq, vo, None, 0, stream=False)
    a, b = streamed.trajectory.n_matches, mem.trajectory.n_matches
    print(f"n_matches equal on {int((a == b).sum())}/{len(a)} pairs")
    assert np.abs(a - b).sum() <= 0.02 * b.sum()
    assert np.isfinite(streamed.vo_abs).all() and streamed.trajectory.ok.all()

    K = pipeline.effective_K(seq).astype(np.float32)
    args = (seq.frames, pipeline.effective_marker_corners(seq, K), seq.marker_present,
            np.asarray(seq.marker_poses[0], np.float32), K, seq.real_marker_length, vo)
    kw = dict(path=str(tmp_path / "state.npz"), chunk=8, preprocess=pipeline.make_preprocessor(seq))

    def stop(done, n):  # at the second chunk, before its save: chunk 1 stays saved
        if done > 9:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        checkpoint.run_sequence_checkpointed(*args, progress=stop, **kw)
    assert int(checkpoint.load_state(kw["path"])["next_start"]) == 9
    resumed = checkpoint.run_sequence_checkpointed(*args, **kw)
    for f in type(resumed)._fields:
        assert np.array_equal(getattr(resumed, f), getattr(streamed.trajectory, f)), f


def test_refine_trajectory_on_cuda(cuda_device):
    """refine_trajectory (windowed BA) on the card with the CPU run's VO
    outputs: FAST and describe once per level on the keyframe stack and the
    match once (all consecutive keyframe pairs), the same keyframes, windows
    and accepted windows as on the CPU, RMS to 1e-2 px and refined poses to
    5e-3 (cuSOLVER against LAPACK, f32)."""
    from droplet_visual_odometry_tpu_torch.backend import refine
    from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig

    seq = _loop_sequence()
    vo = VOConfig(scale_mode="hold", ransac=RansacConfig(n_hypotheses=128, lo_hypotheses=32))
    base = pipeline.run_experiment(seq, vo, device="cpu")
    K = np.asarray(seq.camera.K, np.float32)
    args = (base.vo_abs, base.trajectory.n_inliers, K, refine.RefineConfig())
    kw = dict(marker_corners=pipeline.effective_marker_corners(seq, K), real_marker_length=seq.real_marker_length)
    frames = torch.from_numpy(seq.frames).float()
    cpu, cpu_info = refine.refine_trajectory(frames, *args, **kw)
    _count_from_zero()
    gpu, gpu_info = refine.refine_trajectory(frames.to(cuda_device), *args, **kw)
    assert (cuda_fast.LAUNCHES, cuda_describe.LAUNCHES, cuda_match.LAUNCHES) == (4, 4, 1)
    accepted = lambda info: [r["accepted"] for r in info.get("window_corr", [])]
    assert gpu_info["n_keyframes"] == cpu_info["n_keyframes"] and gpu_info["windows"] == cpu_info["windows"] >= 1
    assert accepted(gpu_info) == accepted(cpu_info)
    np.testing.assert_allclose(gpu_info["rms_px"], cpu_info["rms_px"], atol=1e-2)
    np.testing.assert_allclose(gpu, cpu, atol=5e-3)


@pytest.mark.parametrize("ka,kb", [(300, 512), (512, 300)])
@pytest.mark.parametrize("mode", ["crosscheck", "ratio"])
def test_match_unequal_counts_on_cuda(cuda_device, ka, kb, mode):
    """matcher.match on (P, Ka) against (P, Kb) sets: the smaller padded with
    invalid entries and sent to the kernel (one launch), equal to the same
    call on the CPU (the plain twin) in every output."""
    from droplet_visual_odometry_tpu_torch.frontend import matcher

    g = torch.Generator().manual_seed(ka + kb)
    da = torch.randint(-2**31, 2**31 - 1, (3, ka, 8), generator=g, dtype=torch.int64).to(torch.int32)
    db = torch.randint(-2**31, 2**31 - 1, (3, kb, 8), generator=g, dtype=torch.int64).to(torch.int32)
    va, vb = torch.rand((3, ka), generator=g) > 0.2, torch.rand((3, kb), generator=g) > 0.2
    vb[2] = False
    cpu = matcher.match(da, db, va, vb, mode=mode)
    cuda_match.LAUNCHES = 0
    gpu = matcher.match(*(t.to(cuda_device) for t in (da, db, va, vb)), mode=mode)
    assert cuda_match.LAUNCHES == 1
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu(), b)
    assert int(gpu.idx.max()) < kb


def _stream_sequence():
    return synthetic.render_sequence(synthetic.SyntheticConfig(n_frames=8, width=640, height=480, n_landmarks=350))


def _stream_detections(seq, i):
    """Frame i's marker as a 1-frame MarkerDetections (camera frame: cTm)."""
    from droplet_visual_odometry_tpu_torch import groundtruth
    from droplet_visual_odometry_tpu_torch.core import se3

    t, q = se3.to_translation_quaternion(torch.from_numpy(np.asarray(seq.marker_poses[i], np.float32)))
    return groundtruth.detections_from_arrays(np.zeros((1, 1), np.int32), t.numpy()[None, None],
                                              q.numpy()[None, None], seq.marker_corners[i][None, None])


@pytest.mark.parametrize("frontend", ["orb", "sift"])
def test_online_vo_graph_replay_equals_eager(cuda_device, frontend):
    """OnlineVO on the card captures its push as one CUDA graph at the first
    armed push and replays it: every push's (rel, n_inliers, ok) equals the
    same step run op by op (step_eager, the same features and draws) bit
    for bit; in ORB mode the graph holds one FAST and one describe launch
    per level and one match (captured_launches), the first armed push
    counts its warm-up run's and its capture's, and replays tick no counter."""
    from droplet_visual_odometry_tpu_torch import groundtruth, stream

    seq = _stream_sequence()
    cfg = VOConfig() if frontend == "orb" else VOConfig(frontend="sift", match_mode="ratio", dog_threshold=0.5)
    vo = stream.OnlineVO(np.asarray(seq.camera.K), seq.real_marker_length, cfg=cfg,
                         gt_cfg=groundtruth.GroundTruthConfig(use_base_link=False))
    dets = lambda i: _stream_detections(seq, i)
    vo.push(seq.timestamps[0], seq.frames[0], dets(0))
    counts = []
    for i in range(1, len(seq)):
        want = vo.step_eager(seq.frames[i], dets(i))
        for mod in (cuda_fast, cuda_describe, cuda_match):
            mod.LAUNCHES = 0
        r = vo.push(seq.timestamps[i], seq.frames[i], dets(i))
        counts.append((cuda_fast.LAUNCHES, cuda_describe.LAUNCHES, cuda_match.LAUNCHES))
        assert np.array_equal(want[:16].numpy().reshape(4, 4), r.rel), i
        assert (int(want[16]), bool(want[17])) == (r.n_inliers, r.ok), i
        assert r.ok
    n_levels = VOConfig().n_levels
    if frontend == "orb":
        assert vo.captured_launches == {"fast_score": n_levels, "orb_describe": n_levels, "hamming_match": 1}
        assert counts[0] == (2 * n_levels, 2 * n_levels, 2) and set(counts[1:]) == {(0, 0, 0)}
    gt = np.linalg.inv(np.asarray(seq.marker_poses[-1], np.float64))[:3, 3]
    assert np.linalg.norm(np.linalg.inv(vo.pose.astype(np.float64))[:3, 3] - gt) < 0.25


def test_online_vo_replay_survives_constant_cache_churn(cuda_device):
    """A captured push reads the per-device constants (the resize weights,
    blur taps, tables) by address on every replay, so they must outlive any
    other use of their caches: after 100 other resize shapes on the card and
    the allocator's free memory filled with garbage, every replay still
    equals the eager step bit for bit."""
    from droplet_visual_odometry_tpu_torch import groundtruth, stream
    from droplet_visual_odometry_tpu_torch.frontend import filters

    seq = _stream_sequence()
    vo = stream.OnlineVO(np.asarray(seq.camera.K), seq.real_marker_length,
                         gt_cfg=groundtruth.GroundTruthConfig(use_base_link=False))
    vo.push(seq.timestamps[0], seq.frames[0], _stream_detections(seq, 0))
    vo.push(seq.timestamps[1], seq.frames[1], _stream_detections(seq, 1))  # the capture
    for n in range(100):
        filters.resize_bilinear(torch.ones((1, 300 + n, 200 + n), device=cuda_device), 150 + n, 100 + n)
    shapes = features.level_shapes(480, 640, features.N_LEVELS, features.SCALE_FACTOR)
    garbage = [torch.full((a[d], b[d]), 1e30, device=cuda_device)  # the shapes of the pyramid's resize weights
               for a, b in zip(shapes, shapes[1:]) for d in (0, 1) for _ in range(8)]
    for i in range(2, len(seq)):
        want = vo.step_eager(seq.frames[i], _stream_detections(seq, i))
        r = vo.push(seq.timestamps[i], seq.frames[i], _stream_detections(seq, i))
        assert np.array_equal(want[:16].numpy().reshape(4, 4), r.rel), i
        assert (int(want[16]), bool(want[17]), int(want[18])) == (r.n_inliers, r.ok, r.n_matches), i
    del garbage


# --------------------------------------------------------------------------
# Ingest and the CLIs on the card
# --------------------------------------------------------------------------


def _cli_json(main, argv) -> dict:
    """Run a CLI's main(argv) and return the first JSON object it printed."""
    import contextlib
    import io
    import json

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    text = buf.getvalue()
    return json.JSONDecoder().raw_decode(text, text.index("{"))[0]


def _ingest_sequence():
    seq = synthetic.render_sequence(synthetic.SyntheticConfig(n_frames=12, width=640, height=480, n_landmarks=350))
    seq.marker_present[5:7] = False
    seq.marker_corners[5:7] = np.nan
    return seq


def test_derive_ground_truth_on_cuda_equals_cpu(cuda_device):
    """The ground truth of 64 frames of up to 4 markers on the card: cTm
    within 1e-6 of the CPU's, presence, slots and corners equal, pixel
    lengths within 1e-5 (relative)."""
    from droplet_visual_odometry_tpu_torch import groundtruth as gt

    rng = np.random.default_rng(0)
    ids = rng.integers(0, 6, (64, 4)).astype(np.int32)
    ids[::5] = -1
    q = rng.normal(size=(64, 4, 4))
    dets = gt.detections_from_arrays(ids, rng.normal(size=(64, 4, 3)), q / np.linalg.norm(q, axis=-1, keepdims=True),
                                     rng.uniform(0, 1440, (64, 4, 4, 2)))
    for use_base_link in (True, False):
        cfg = gt.GroundTruthConfig(use_base_link=use_base_link)
        cpu = gt.derive_ground_truth(dets, 3, cfg)
        gpu = gt.derive_ground_truth(gt.MarkerDetections(*(a.to(cuda_device) for a in dets)), 3, cfg)
        assert gpu.cTm.is_cuda
        np.testing.assert_allclose(gpu.cTm.cpu().numpy(), cpu.cTm.numpy(), rtol=0, atol=1e-6)
        assert torch.equal(gpu.present.cpu(), cpu.present) and torch.equal(gpu.corners.cpu(), cpu.corners)
        np.testing.assert_allclose(gpu.pixel_length.cpu().numpy(), cpu.pixel_length.numpy(), rtol=1e-5)


def test_cli_convert_and_run_on_cuda_equal_in_process(cuda_device, tmp_path):
    """A 12-frame 640x480 bag (lz4 chunks) converted by the CLI on the card
    (no --platform), then run_experiment's CLI on the card (backend none,
    384 hypotheses): equal to pipeline.run_experiment on the converted
    sequence in the same process (the same draws on the same card): match
    and inlier counts equal, the TUM estimate within 1e-5, the ATE within 1e-6."""
    import torch_bag_data as bags

    from droplet_visual_odometry_tpu_torch.cli import convert, run_experiment
    from droplet_visual_odometry_tpu_torch.data import sequence
    from droplet_visual_odometry_tpu_torch.eval import tum

    seq = _ingest_sequence()
    bag, calib, npz = str(tmp_path / "r.bag"), str(tmp_path / "cam.yaml"), str(tmp_path / "s.npz")
    bags.sequence_bag(bag, seq, "lz4")
    bags.write_calibration(calib, seq.camera)
    assert convert.main(["--bag", bag, "--calibration", calib, "--marker-id", "0", "--marker-length",
                         str(seq.real_marker_length), "--camera-frame-detections", "--out", npz]) == 0
    conv = sequence.load(npz)
    assert np.array_equal(conv.frames, seq.frames) and np.array_equal(conv.marker_present, seq.marker_present)
    np.testing.assert_allclose(conv.marker_poses, seq.marker_poses, rtol=0, atol=1e-6)

    _count_from_zero()
    out = str(tmp_path / "out")
    summary = _cli_json(run_experiment.main, ["--sequence", npz, "--out-dir", out, "--backend", "none",
                                              "--ransac-hypotheses", "384", "--seed", "0"])
    assert (cuda_fast.LAUNCHES, cuda_describe.LAUNCHES, cuda_match.LAUNCHES) == (8, 8, 2)
    ref = pipeline.run_experiment(conv, VOConfig(scale_mode="hold"), None, 0, backend="none")
    assert summary["config"]["ransac"]["n_hypotheses"] == 384
    assert summary["median_matches"] == int(np.median(ref.trajectory.n_matches))
    assert summary["median_inliers"] == int(np.median(ref.trajectory.n_inliers))
    assert abs(summary["ate_rmse_m"] - ref.ate.rmse) <= 1e-6
    _, est = tum.read_tum(f"{out}/stamped_traj_estimate_absolute.txt")
    np.testing.assert_allclose(est, ref.vo_abs, rtol=0, atol=1e-5)  # through the TUM quaternion


def test_run_experiment_cli_runs_on_cuda_by_default(cuda_device, tmp_path):
    """run_experiment's CLI without --platform: the synthetic source on the
    card, through all three kernels, with a finite summary."""
    from droplet_visual_odometry_tpu_torch.cli import run_experiment

    _count_from_zero()
    summary = _cli_json(run_experiment.main, ["--synthetic", "--n-frames", "8", "--backend", "none",
                                              "--out-dir", str(tmp_path / "out")])
    assert (cuda_fast.LAUNCHES, cuda_describe.LAUNCHES, cuda_match.LAUNCHES) == (8, 8, 2)
    assert summary["n_frames"] == 8 and np.isfinite(summary["ate_rmse_m"]) and summary["ok_fraction"] == 1.0


@pytest.fixture
def nccl_world_one(cuda_device, tmp_path):
    """A world of one rank over NCCL on the card (launch.initialize with a
    file store), torn down after the test by launch.shutdown (the mesh's
    captured programs dropped first)."""
    import torch.distributed as dist

    from droplet_visual_odometry_tpu_torch.parallel import launch

    assert launch.initialize(f"file://{tmp_path / 'store'}", 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        yield launch.global_mesh()
    finally:
        launch.shutdown()


def test_shard_pair_vo_on_nccl_world_one_equals_pair_vo_batched(nccl_world_one):
    """shard_pair_vo over a one-rank NCCL mesh (its all_gather really runs,
    inside the captured graph) equals pair_vo_batched on the same frames
    and draws bit for bit, and describes the 2B frames in one batch: FAST
    and describe once per pyramid level, the match once, in a program
    captured once (its warm-up and capture tick each kernel: 8/8/2)."""
    from droplet_visual_odometry_tpu_torch.parallel import sharding

    seq = synthetic.render_sequence(synthetic.SyntheticConfig(n_frames=9, width=256, height=192, n_landmarks=300))
    cfg = VOConfig(n_keypoints=256)
    frames = torch.from_numpy(seq.frames).float()
    corners = np.nan_to_num(seq.marker_corners)
    args = (frames[:-1], frames[1:], corners[:-1], corners[1:], seq.marker_present[:-1] & seq.marker_present[1:],
            seq.camera.K, seq.real_marker_length, cfg)
    mesh = nccl_world_one
    assert (mesh.size, mesh.rank, mesh.device) == (1, 0, torch.device("cuda", torch.cuda.current_device()))
    _count_from_zero()
    rels = sharding.shard_pair_vo(mesh, *args, seed=5)
    torch.cuda.synchronize()
    assert (cuda_fast.LAUNCHES, cuda_describe.LAUNCHES, cuda_match.LAUNCHES) == (8, 8, 2)
    assert rels.is_cuda and rels.shape == (8, 4, 4) and bool(torch.isfinite(rels).all())
    assert torch.equal(rels, sharding.pair_vo_batched(*args, seed=5))


def _random_pose_graph(device, n=24, seed=0):
    """A drifting chain with loop edges and full SPD weights, in torch."""
    from droplet_visual_odometry_tpu_torch.backend import pose_graph
    from droplet_visual_odometry_tpu_torch.core import se3

    g = torch.Generator().manual_seed(seed)
    steps = se3.se3_exp(torch.cat([0.1 * torch.randn(n - 1, 3, generator=g), 0.05 * torch.randn(n - 1, 3, generator=g)], 1))
    true = [torch.eye(4)]
    for s in steps:
        true.append(true[-1] @ s)
    true = torch.stack(true)
    ei = torch.tensor(list(range(n - 1)) + [0, 2, 5, 3, 8, 1, 11])
    ej = torch.tensor(list(range(1, n)) + [15, 18, 19, 12, 17, 10, 23])
    meas = se3.inverse(true[ei]) @ true[ej] @ se3.se3_exp(0.01 * torch.randn(len(ei), 6, generator=g))
    drift = se3.se3_exp(0.03 * torch.randn(n, 6, generator=g))
    drift[0] = torch.eye(4)
    A = torch.randn(len(ei), 6, 6, generator=g)
    w = A @ A.transpose(-1, -2) / 6 + 0.1 * torch.eye(6)
    return pose_graph.PoseGraph(*(t.to(device) for t in (true @ drift, ei, ej, meas, w)))


def test_edge_sharded_optimize_on_nccl_world_one(nccl_world_one):
    """optimize(mesh) over a one-rank NCCL mesh (one all_reduce of the
    edge-local product a CG step) against the plain optimize on the card:
    poses within 1e-4 (index_add_ sums in no fixed order on the card,
    ROADMAP C.2), the cost falls; and run_ba_distributed against run_ba:
    poses 2e-3, points 2e-2 (the reference's distributed-BA tolerances)."""
    from droplet_visual_odometry_tpu_torch.backend import ba, pose_graph
    from droplet_visual_odometry_tpu_torch.parallel import distributed_ba

    mesh = nccl_world_one
    graph = _random_pose_graph(mesh.device)
    plain = pose_graph.optimize(graph)
    sharded = pose_graph.optimize(graph, mesh=mesh)
    assert float(sharded.final_cost) < float(sharded.initial_cost)
    np.testing.assert_allclose(sharded.poses.cpu().numpy(), plain.poses.cpu().numpy(), atol=1e-4)
    window = ba.BAWindow(*(t.to(mesh.device) for t in _ba_window(seed=4, L=121)))
    single = ba.run_ba(window)
    dist_res = distributed_ba.run_ba_distributed(mesh, window)
    assert float(dist_res.final_cost) < 0.1 * float(dist_res.initial_cost)
    np.testing.assert_allclose(dist_res.poses.cpu().numpy(), single.poses.cpu().numpy(), atol=2e-3)
    np.testing.assert_allclose(dist_res.points.cpu().numpy(), single.points.cpu().numpy(), atol=2e-2)


def test_sharded_programs_capture_their_collectives_on_nccl_world_one(nccl_world_one):
    """Over a one-rank NCCL mesh each sharded program (shard_pair_vo with its
    all_gather, optimize's GN step with its broadcast and all_reduces,
    run_ba_distributed with its psums and gather) is captured once, over
    the mesh, and its replays equal its eager twin: bit for bit for the
    pair VO and BA, within 1e-4 for optimize (index_add_ sums in no fixed
    order on the card, ROADMAP C.2). One pair-VO replay launches 4/4/1,
    the other two none of the kernels. graphs.clear(mesh=) then leaves no
    program of the mesh behind (before the fixture destroys the group)."""
    from droplet_visual_odometry_tpu_torch.backend import ba, pose_graph
    from droplet_visual_odometry_tpu_torch.parallel import distributed_ba, sharding
    from droplet_visual_odometry_tpu_torch.utils import graphs

    mesh = nccl_world_one
    graphs.clear()
    seq = synthetic.render_sequence(synthetic.SyntheticConfig(n_frames=9, width=256, height=192, n_landmarks=300))
    frames = torch.from_numpy(seq.frames).float()
    corners = np.nan_to_num(seq.marker_corners)
    args = (frames[:-1], frames[1:], corners[:-1], corners[1:], seq.marker_present[:-1] & seq.marker_present[1:],
            seq.camera.K, seq.real_marker_length, VOConfig(n_keypoints=256))
    graph = _random_pose_graph(mesh.device)
    window = ba.BAWindow(*(t.to(mesh.device) for t in _ba_window(seed=4, L=121)))
    calls = {
        "shard_pair_vo": (lambda: sharding.shard_pair_vo(mesh, *args, seed=5),
                          lambda: sharding.shard_pair_vo_eager(mesh, *args, seed=5)),
        "optimize_step": (lambda: pose_graph.optimize(graph, mesh=mesh),
                          lambda: pose_graph.optimize_eager(graph, mesh=mesh)),
        "run_ba_distributed": (lambda: distributed_ba.run_ba_distributed(mesh, window),
                               lambda: distributed_ba.run_ba_distributed_eager(mesh, window)),
    }
    for name, (graphed, eager) in calls.items():
        first, again, ref = graphed(), graphed(), eager()
        torch.cuda.synchronize()
        progs = [p for p in graphs.programs() if p.name == name]
        assert len(progs) == 1 and progs[0].mesh is mesh, name
        if name == "shard_pair_vo":
            assert torch.equal(first, again) and torch.equal(again, ref)
        elif name == "optimize_step":
            np.testing.assert_allclose(again.poses.cpu().numpy(), ref.poses.cpu().numpy(), rtol=0, atol=1e-4)
            assert float(again.final_cost) < float(again.initial_cost)
        else:
            assert all(torch.equal(x, y) and torch.equal(z, y) for x, y, z in zip(again, ref, first))
    launches = {p.name: p.captured_launches for p in graphs.programs() if p.mesh is mesh}
    assert launches["shard_pair_vo"] == {"fast_score": 4, "orb_describe": 4, "hamming_match": 1}
    assert set(launches["optimize_step"].values()) == set(launches["run_ba_distributed"].values()) == {0}
    graphs.clear(mesh=mesh)
    assert not [p for p in graphs.programs() if p.mesh is not None]
