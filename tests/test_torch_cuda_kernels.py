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
from droplet_visual_odometry_tpu_torch.ops import cuda_ba, cuda_describe, cuda_fast, cuda_l2match, cuda_match, cuda_pcg

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
    for mod in (cuda_fast, cuda_describe, cuda_match, cuda_pcg, cuda_ba, cuda_l2match):
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
    assert cuda_pcg.LAUNCHES == 2  # the GN step's warm-up and capture: its CG in the kernel
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


def ba_window64(seed=0, W=8, L=1000, spacing=0.25, noise_px=0.5):
    """A float64 BA window: W keyframes `spacing` m apart along x (each
    with 2% of it of jitter and 0.03 rad of rotation) looking at L points
    4-8 m ahead, observed with noise_px of noise, 3% of the observations
    15 px off (Huber's side), 20% of the rest masked out; the poses but the
    first and the points perturbed."""
    from droplet_visual_odometry_tpu_torch.backend import ba
    from droplet_visual_odometry_tpu_torch.core import se3

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L), rng.uniform(4, 8, L)], 1)
    xi = np.concatenate([np.stack([spacing * np.arange(W), 0.02 * np.arange(W), np.zeros(W)], 1)
                         + rng.normal(scale=0.08 * spacing, size=(W, 3)), rng.normal(scale=0.03, size=(W, 3))], 1)
    poses = se3.se3_exp(torch.from_numpy(xi))
    K = torch.tensor([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], dtype=torch.float64)
    p, uv = ba._project(poses, torch.from_numpy(pts), K)
    uv = uv + torch.from_numpy(rng.normal(scale=noise_px, size=tuple(uv.shape)))
    uv[torch.from_numpy(rng.uniform(size=(W, L)) < 0.03)] += 15.0
    inside = (p[..., 2] > 0.1) & (uv[..., 0] > 0) & (uv[..., 0] < 640) & (uv[..., 1] > 0) & (uv[..., 1] < 480)
    mask = inside & torch.from_numpy(rng.uniform(size=(W, L)) > 0.2)
    dxi = rng.normal(scale=0.01, size=(W, 6))
    dxi[0] = 0
    poses0 = se3.se3_exp(torch.from_numpy(dxi)) @ poses
    pts0 = torch.from_numpy(pts + rng.normal(scale=0.05, size=pts.shape))
    return ba.BAWindow(poses=poses0.contiguous(), points=pts0, obs_uv=uv.contiguous(), obs_mask=mask, K=K)


def _assert_ba_close(out, ref, tol_m, tol_rel):
    np.testing.assert_allclose(out.poses.cpu().numpy(), ref.poses.cpu().numpy(), rtol=0, atol=tol_m)
    np.testing.assert_allclose(out.points.cpu().numpy(), ref.points.cpu().numpy(), rtol=0, atol=tol_m)
    for f in ("initial_cost", "final_cost", "rms_px"):
        np.testing.assert_allclose(float(getattr(out, f)), float(getattr(ref, f)), rtol=tol_rel, atol=0)


@pytest.mark.parametrize("W,L,n_fixed,seed", [(8, 1000, 2, 0), (4, 1000, 2, 1), (8, 300, 1, 3), (8, 100, 2, 5)])
def test_windowed_ba_kernel_matches_run_ba_eager(cuda_device, W, L, n_fixed, seed):
    """run_ba on a float64 CUDA window runs the kernel, one launch and no
    captured program, and lands within 1e-9 m (poses, points) and 1e-9
    relative (costs, rms_px) of run_ba_eager on the card (cuSOLVER's LU)
    and on the CPU (LAPACK's), the held poses bit for bit as given: the
    ba cell's window (8, 1000) on a cluster of 8 blocks, a short last
    window (W = 4), the monocular scale left to the data (n_fixed = 1) and
    a small window (L = 100). At W = 4 and n_fixed = 1 the scale is so weakly
    held that two summation orders of the twin part by 3.7e-9 m on the CPU,
    against 1.5e-13 m at W = 8, so n_fixed = 1 runs at W = 8."""
    from droplet_visual_odometry_tpu_torch.backend import ba
    from droplet_visual_odometry_tpu_torch.utils import graphs

    window = ba_window64(seed, W, L)
    card = ba.BAWindow(*(t.to(cuda_device) for t in window))
    cfg = ba.BAConfig(n_fixed=n_fixed)
    graphs.clear()
    assert ba.runs_in_kernel(card) and cuda_ba.plan(W, L) == 8
    before = cuda_ba.LAUNCHES
    out = ba.run_ba(card, cfg)
    assert cuda_ba.LAUNCHES == before + 1 and not graphs.programs()
    assert float(out.final_cost) < float(out.initial_cost)
    assert torch.equal(out.poses[:n_fixed].cpu(), window.poses[:n_fixed])
    for ref in (ba.run_ba_eager(card, cfg), ba.run_ba_eager(window, cfg)):
        _assert_ba_close(out, ref, 1e-9, 1e-9)


def test_windowed_ba_kernel_on_a_near_degenerate_window(cuda_device):
    """Keyframes 2 mm apart (a hover: ROADMAP C.2's flat valley), where
    the scale and the depths are barely observed: the kernel within 3.9e-7
    m of run_ba_eager on the card and on the CPU, the largest gap PR 18
    measured between the captured graph and the op path in float64 (on the
    CPU two summation orders of the twin part by 1.8e-9 m here)."""
    from droplet_visual_odometry_tpu_torch.backend import ba

    window = ba_window64(7, 8, 1000, spacing=0.002)
    card = ba.BAWindow(*(t.to(cuda_device) for t in window))
    cfg = ba.BAConfig(n_fixed=2)
    out = ba.run_ba(card, cfg)
    for ref in (ba.run_ba_eager(card, cfg), ba.run_ba_eager(window, cfg)):
        _assert_ba_close(out, ref, 3.9e-7, 1e-9)


@pytest.mark.parametrize("L", [1000, 3])
def test_windowed_ba_kernel_repeats_bit_for_bit(cuda_device, L):
    """Two launches on the same window give the same bits, on a cluster of
    8 blocks and of 3 (one a landmark)."""
    from droplet_visual_odometry_tpu_torch.backend import ba

    card = ba.BAWindow(*(t.to(cuda_device) for t in ba_window64(2, 8, L)))
    first, second = ba.run_ba(card, ba.BAConfig(n_fixed=2)), ba.run_ba(card, ba.BAConfig(n_fixed=2))
    assert all(torch.equal(u, v) for u, v in zip(first, second))


def test_windowed_ba_kernel_checks_its_inputs(cuda_device):
    """run_ba_cuda raises on a window split across devices, float32, a
    mask that is not bool, a non-contiguous tensor or a W past the plan;
    run_ba takes a float32 or W = 19 window to the captured op program."""
    from droplet_visual_odometry_tpu_torch.backend import ba
    from droplet_visual_odometry_tpu_torch.utils import graphs

    card = ba.BAWindow(*(t.to(cuda_device) for t in ba_window64(4, 4, 60)))
    cfg = ba.BAConfig(n_fixed=2)
    bad = {
        "split": card._replace(points=card.points.cpu()),
        "float32": card._replace(poses=card.poses.float()),
        "mask": card._replace(obs_mask=card.obs_mask.to(torch.uint8)),
        "strided": card._replace(obs_uv=card.obs_uv.transpose(0, 1).contiguous().transpose(0, 1)),
        "W": ba.BAWindow(*(t.to(cuda_device) for t in ba_window64(4, 19, 60))),
    }
    before = cuda_ba.LAUNCHES
    for name, w in bad.items():
        with pytest.raises(ValueError):
            cuda_ba.run_ba_cuda(w, cfg)
    assert cuda_ba.LAUNCHES == before
    graphs.clear()
    for w in (ba.BAWindow(*(t.float() if t.is_floating_point() else t for t in card)), bad["W"]):
        assert not ba.runs_in_kernel(w)
        ba.run_ba(w, cfg)
    assert cuda_ba.LAUNCHES == before and len([p for p in graphs.programs() if p.name == "run_ba"]) == 2


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
    match once (all consecutive keyframe pairs), the windowed BA kernel
    once a window run, every `ba.solve` span counting ba_kernel = 1, the
    same keyframes, windows and accepted windows as on the CPU, RMS to 1e-2
    px and refined poses to 5e-3 (the kernel's LDL^T against LAPACK's LU,
    float64)."""
    import time

    from droplet_visual_odometry_tpu_torch.backend import refine
    from droplet_visual_odometry_tpu_torch.estimation.ransac import RansacConfig
    from droplet_visual_odometry_tpu_torch.utils import profiling

    seq = _loop_sequence()
    vo = VOConfig(scale_mode="hold", ransac=RansacConfig(n_hypotheses=128, lo_hypotheses=32))
    base = pipeline.run_experiment(seq, vo, device="cpu")
    K = np.asarray(seq.camera.K, np.float32)
    args = (base.vo_abs, base.trajectory.n_inliers, K, refine.RefineConfig())
    kw = dict(marker_corners=pipeline.effective_marker_corners(seq, K), real_marker_length=seq.real_marker_length)
    frames = torch.from_numpy(seq.frames).float()
    cpu, cpu_info = refine.refine_trajectory(frames, *args, **kw)
    _count_from_zero()
    t0 = time.perf_counter()
    gpu, gpu_info = refine.refine_trajectory(frames.to(cuda_device), *args, **kw)
    assert (cuda_fast.LAUNCHES, cuda_describe.LAUNCHES, cuda_match.LAUNCHES) == (4, 4, 1)
    assert cuda_ba.LAUNCHES == gpu_info["windows"]
    solves = [r for r in profiling.snapshot(t0) if r.name == "ba.solve"]
    assert len(solves) == gpu_info["windows"] and all(r.attrs["ba_kernel"] == 1 for r in solves)
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
    dets = lambda i: groundtruth.frame_detections(seq, i)
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
        assert vo.captured_launches == {"fast_score": n_levels, "orb_describe": n_levels, "hamming_match": 1,
                                        "pose_graph_pcg": 0, "windowed_ba": 0, "l2_match": 0}
        assert counts[0] == (2 * n_levels, 2 * n_levels, 2) and set(counts[1:]) == {(0, 0, 0)}
    else:
        assert vo.captured_launches["l2_match"] == 1 and vo.captured_launches["hamming_match"] == 0
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
    vo.push(seq.timestamps[0], seq.frames[0], groundtruth.frame_detections(seq, 0))
    vo.push(seq.timestamps[1], seq.frames[1], groundtruth.frame_detections(seq, 1))  # the capture
    for n in range(100):
        filters.resize_bilinear(torch.ones((1, 300 + n, 200 + n), device=cuda_device), 150 + n, 100 + n)
    shapes = features.level_shapes(480, 640, features.N_LEVELS, features.SCALE_FACTOR)
    garbage = [torch.full((a[d], b[d]), 1e30, device=cuda_device)  # the shapes of the pyramid's resize weights
               for a, b in zip(shapes, shapes[1:]) for d in (0, 1) for _ in range(8)]
    for i in range(2, len(seq)):
        want = vo.step_eager(seq.frames[i], groundtruth.frame_detections(seq, i))
        r = vo.push(seq.timestamps[i], seq.frames[i], groundtruth.frame_detections(seq, i))
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


def _chain_graph(device, n, n_loops, form="full", seed=0, bucket=True):
    """A drifting chain of n nodes plus n_loops random loop edges with
    scalar, diagonal or full SPD weights, padded to refine's buckets."""
    from droplet_visual_odometry_tpu_torch.backend import pose_graph
    from droplet_visual_odometry_tpu_torch.core import se3

    g = torch.Generator().manual_seed(seed)
    steps = se3.se3_exp(torch.cat([0.1 * torch.randn(n - 1, 3, generator=g), 0.05 * torch.randn(n - 1, 3, generator=g)], 1))
    true = [torch.eye(4)]
    for s in steps:
        true.append(true[-1] @ s)
    true = torch.stack(true)
    li = torch.randint(0, n // 2, (n_loops,), generator=g)
    lj = li + n // 4 + torch.randint(0, n // 4, (n_loops,), generator=g)
    ei, ej = torch.cat([torch.arange(n - 1), li]), torch.cat([torch.arange(1, n), lj])
    meas = se3.inverse(true[ei]) @ true[ej] @ se3.se3_exp(0.01 * torch.randn(len(ei), 6, generator=g))
    drift = se3.se3_exp(0.03 * torch.randn(n, 6, generator=g))
    drift[0] = torch.eye(4)
    if form == "scalar":
        w = 0.5 + 1.5 * torch.rand(len(ei), generator=g)
    elif form == "diag":
        w = 0.2 + 2.8 * torch.rand(len(ei), 6, generator=g)
    else:
        A = torch.randn(len(ei), 6, 6, generator=g)
        w = A @ A.transpose(-1, -2) / 6 + 0.1 * torch.eye(6)
    graph = pose_graph.PoseGraph(true @ drift, ei, ej, meas, w)
    if bucket:
        graph = pose_graph.pad_graph(graph, pose_graph.next_bucket(n), pose_graph.next_bucket(len(ei)))
    return pose_graph.PoseGraph(*(t.to(device) for t in graph))


def _pcg_system(graph, damping=1e-6):
    """(B, edge_i, edge_j, b, Minv) of the graph's first GN step, as
    pose_graph._solve_pcg builds them, row-major."""
    from droplet_visual_odometry_tpu_torch.backend import pose_graph

    M = graph.poses.shape[0]
    B, g = pose_graph._edge_blocks(graph.poses, graph)
    b, Minv = pose_graph._pcg_system(M, graph, B, g, damping)
    return B.contiguous(), graph.edge_i, graph.edge_j, b, Minv


def _pcg_three_ways(system):
    """The kernel, its plain twin op by op on the card, and the plain twin in
    float64: ((x, live) each), the kernel's launch counted."""
    before = cuda_pcg.LAUNCHES
    out = cuda_pcg.pcg_cuda(*system, 1e-6, 100, 1e-8)
    ref = cuda_pcg.pcg_plain(*system, 1e-6, 100, 1e-8)
    f64 = cuda_pcg.pcg_plain(*(t.double() if t.is_floating_point() else t for t in system), 1e-6, 100, 1e-8)
    torch.cuda.synchronize()
    assert cuda_pcg.LAUNCHES == before + 1 and out[1].dtype == torch.int32
    return out, ref, f64


def _rel(x, ref):
    return float((x.double() - ref.double()).abs().max()) / float(ref.abs().max())


@pytest.mark.parametrize("form", ["scalar", "diag", "full"])
@pytest.mark.parametrize("n,n_loops,bucket", [(41, 9, (64, 64)), (257, 255, (512, 512)), (20, 3, (32, 32))])
def test_pcg_kernel_matches_the_plain_loop(cuda_device, form, n, n_loops, bucket):
    """The kernel against its plain twin (op by op on the card) and the same
    loop in float64, on a GN step's system at the offline cell's bucket (41
    keyframes in 64), at the stream cell's (512, 512) on a graph with as
    many loop edges as chain edges, and on a mostly padded graph, for each
    weight form: the same live count, and x within 1e-4 of max |x| of
    each. On the CPU two f32 summation orders (the edges reversed) part by
    at most 2.1e-5 on these systems and 4.7e-6 at (512, 512)."""
    graph = _chain_graph(cuda_device, n, n_loops, form, seed=n)
    assert (graph.poses.shape[0], graph.edge_i.shape[0]) == bucket
    (x, live), (x_ref, live_ref), (x64, live64) = _pcg_three_ways(_pcg_system(graph))
    assert int(live) == int(live_ref) == int(live64)
    assert _rel(x, x_ref) <= 1e-4 and _rel(x, x64) <= 1e-4
    assert float(x[0].abs().max()) == 0.0 and float(x[n:].abs().max()) == 0.0  # gauge and padding


@pytest.mark.parametrize("form", ["scalar", "diag", "full"])
def test_pcg_kernel_unconverged_at_the_stream_bucket(cuda_device, form):
    """At the stream cell's bucket with its 428 keyframes and 80 loop edges,
    100 CG steps do not converge, and unconverged f32 CG amplifies
    rounding: on the CPU the plain loop lies up to 9.5e-5 from float64 here
    and 2.8e-5 from itself with the edges reversed, and on an H100 the
    kernel and the plain loop part by up to 3.7e-4. So this system checks
    the live count, the gauge and padding, and x within 5e-4 of max |x| of
    float64; the 1e-4 hold on the kernel is made on the converging systems
    above and below."""
    graph = _chain_graph(cuda_device, 428, 80, form, seed=428)
    (x, live), (_, live_ref), (x64, live64) = _pcg_three_ways(_pcg_system(graph))
    assert int(live) == int(live_ref) == int(live64) == 100
    assert _rel(x, x64) <= 5e-4
    assert float(x[0].abs().max()) == 0.0 and float(x[428:].abs().max()) == 0.0


@pytest.mark.parametrize("n,n_loops,bucket,form,blocks", [
    (400, 600, (512, 1024), "scalar", 2), (400, 600, (512, 1024), "diag", 2), (400, 600, (512, 1024), "full", 2),
    (600, 424, (1024, 1024), "scalar", 2), (600, 424, (1024, 1024), "full", 2),
    (1100, 2900, (2048, 4096), "scalar", 7), (1100, 2900, (2048, 4096), "diag", 7),
])
def test_pcg_kernel_in_a_cluster_matches_the_plain_loop(cuda_device, n, n_loops, bucket, form, blocks):
    """Past one block's shared memory the kernel runs on a thread block
    cluster (ops/cuda_pcg.plan), p and y exchanged through distributed
    shared memory: against the plain loop and float64 as at one block,
    on converging graphs (two f32 orders part by at most 1.7e-5 on the CPU),
    to 1e-4 of max |x|, with the same live count; two launches give the
    same bits."""
    graph = _chain_graph(cuda_device, n, n_loops, form, seed=n)
    assert (graph.poses.shape[0], graph.edge_i.shape[0]) == bucket and cuda_pcg.plan(*bucket)[0] == blocks
    system = _pcg_system(graph)
    (x, live), (x_ref, live_ref), (x64, live64) = _pcg_three_ways(system)
    assert int(live) == int(live_ref) == int(live64)
    assert _rel(x, x_ref) <= 1e-4 and _rel(x, x64) <= 1e-4
    assert float(x[0].abs().max()) == 0.0 and float(x[n:].abs().max()) == 0.0
    again = cuda_pcg.pcg_cuda(*system, 1e-6, 100, 1e-8)
    assert torch.equal(again[0], x) and torch.equal(again[1], live)


@pytest.mark.parametrize("M,blocks", [(651, 1), (652, 2)])
def test_pcg_kernel_takes_the_largest_graph_fits_admits(cuda_device, M, blocks):
    """At (651, 651), the largest square graph one block takes, the launch
    takes the shared memory the wrapper counted (one byte more than the
    card allows would be refused at launch); at (652, 652) the kernel takes
    two blocks. Both match the plain loop's live count and float64 to 5e-4
    (a chain with one loop edge does not converge in 100 steps)."""
    assert cuda_pcg.plan(M, M)[0] == blocks
    graph = _chain_graph(cuda_device, M, 1, "full", seed=637, bucket=False)
    (x, live), (_, live_ref), (x64, _) = _pcg_three_ways(_pcg_system(graph))
    assert int(live) == int(live_ref)
    assert _rel(x, x64) <= 5e-4


def test_pcg_kernel_stops_where_the_while_loop_stops(cuda_device):
    """A well-conditioned graph (a chain with as many loop edges as nodes)
    converges before the cap: the kernel's live count equals the
    reference's while loop's step count on the same system, and the loop
    stopped early."""
    from test_torch_profiling import _pcg_while

    B, ei, ej, b, Minv = _pcg_system(_chain_graph(cuda_device, 24, 24, "full", seed=3))
    counts = []
    x_ref, _ = _pcg_while(cuda_pcg.matvec_local(B, ei, ej, 1e-6, b.shape[0]), b, Minv, 100, 1e-8, counts=counts)
    x, live = cuda_pcg.pcg_cuda(B, ei, ej, b, Minv, 1e-6, 100, 1e-8)
    assert 0 < counts[0] < 100 and int(live) == counts[0]
    assert _rel(x, x_ref) <= 1e-4


@pytest.mark.parametrize("bucket", [(512, 512), (512, 1024)])
def test_pcg_kernel_repeats_bit_for_bit(cuda_device, bucket):
    """Two launches on the same system give the same bits, on a graph whose
    hub node has 90 loop edges (91 terms in one Hx entry) and whose
    padding puts its filler self-loops on node 0, in one block and in a
    cluster of two; an edge end outside the graph makes x NaN and the live
    count 0."""
    from droplet_visual_odometry_tpu_torch.backend import pose_graph

    graph = _chain_graph(cuda_device, 300, 90, "full", seed=7, bucket=False)
    hub = graph.edge_i.clone()
    hub[299:] = 5  # every loop edge leaves node 5
    graph = pose_graph.pad_graph(graph._replace(edge_i=hub), *bucket)  # zero-weight self-loops on node 0
    system = _pcg_system(graph)
    first = cuda_pcg.pcg_cuda(*system, 1e-6, 100, 1e-8)
    second = cuda_pcg.pcg_cuda(*system, 1e-6, 100, 1e-8)
    assert all(torch.equal(u, v) for u, v in zip(first, second)) and bool(torch.isfinite(first[0]).all())
    B, ei, ej, b, Minv = system
    bad = ej.clone()
    bad[3] = b.shape[0]
    x, live = cuda_pcg.pcg_cuda(B, ei, bad, b, Minv, 1e-6, 100, 1e-8)
    assert bool(torch.isnan(x).all()) and int(live) == 0


def test_optimize_step_runs_its_cg_in_one_kernel_launch(cuda_device):
    """On one device the GN step's program holds one PCG kernel launch and
    no other kernel of the port (captured_launches), every pg.step carries
    pcg_kernel = 1, and optimize agrees with the op-by-op twin
    (optimize_eager) in float64. On a chain with three loop edges f32 GN
    drifts along a flat valley of the cost: on the CPU two f32 summation
    orders end 1.24e-4 apart in the poses and 3e-8 apart in the cost, one
    of them 1.6e-7 from float64; so there the final cost is held to 1e-6
    relative. On a chain with as many loop edges as nodes, where two f32
    orders end 2.7e-7 apart, the poses are held to 1e-4. The CG, captured
    alone, replays bit for bit; the whole step does not: its rhs and
    block-diagonal assembly stays index_add_, whose block diagonal differs
    from run to run on the card even where no slot sums more than two
    non-zero terms."""
    import time

    from droplet_visual_odometry_tpu_torch.backend import pose_graph
    from droplet_visual_odometry_tpu_torch.utils import graphs, profiling

    f64 = lambda g: pose_graph.PoseGraph(*(t.double() if t.is_floating_point() else t for t in g))
    graph = _chain_graph(cuda_device, 24, 0, "full", seed=11)
    loops = pose_graph.add_edges(graph, [1, 3, 6], [14, 18, 21], graph.edge_meas[[1, 3, 6]] @ graph.edge_meas[[2, 4, 7]],
                                 graph.edge_weight[:3])
    loops = pose_graph.pad_graph(loops, 32, 64)
    _count_from_zero()
    t0 = time.perf_counter()
    with profiling.span("test.root"):
        res = pose_graph.optimize(loops)
    t1 = time.perf_counter()
    steps = [r for r in profiling.snapshot(t0, t1) if r.name == "pg.step"]
    assert len(steps) == 10 and all(r.attrs["pcg_kernel"] == 1 for r in steps)
    progs = [p for p in graphs.programs() if p.name == "optimize_step"]
    assert len(progs) == 1 and progs[0].captured_launches == {"fast_score": 0, "orb_describe": 0, "hamming_match": 0,
                                                              "pose_graph_pcg": 1, "windowed_ba": 0,
                                                              "l2_match": 0}
    assert cuda_pcg.LAUNCHES == 2  # the warm-up and the capture; replays tick no counter
    assert float(res.final_cost) < float(res.initial_cost)
    eager = pose_graph.optimize_eager(f64(loops))
    assert abs(float(res.final_cost) - float(eager.final_cost)) <= 1e-6 * float(eager.final_cost)
    dense = _chain_graph(cuda_device, 24, 24, "full", seed=11)
    np.testing.assert_allclose(pose_graph.optimize(dense).poses.cpu().numpy(),
                               pose_graph.optimize_eager(f64(dense)).poses.cpu().numpy(), rtol=0, atol=1e-4)
    system = _pcg_system(loops)
    body = lambda *t: cuda_pcg.pcg_cuda(*t, 1e-6, 100, 1e-8)
    first, second = (graphs.run("pcg_alone", body, system, None, cuda_device) for _ in range(2))
    assert all(torch.equal(u, v) for u, v in zip(first, second))


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
    assert launches["shard_pair_vo"] == {"fast_score": 4, "orb_describe": 4, "hamming_match": 1, "pose_graph_pcg": 0,
                                         "windowed_ba": 0, "l2_match": 0}
    assert set(launches["optimize_step"].values()) == set(launches["run_ba_distributed"].values()) == {0}
    graphs.clear(mesh=mesh)
    assert not [p for p in graphs.programs() if p.mesh is not None]


# -- the float (squared-L2) match kernel, csrc/l2_match.cu ---------------------------
#
# Tolerances: descriptors are unit-norm (SIFT's and SURF's are), so a squared
# distance is at most 4 and is |a|^2 + |b|^2 - 2 a.b over D float32 terms;
# the kernel and the twin (cuBLAS, TF32 off) sum those terms in different
# orders, which moves a distance by a few ulps of 4 (2e-6 holds them). An
# index is compared where the line's best is ahead of its second by more
# than 1e-5, five times that: nearer ties may fall either way.

L2_DIST_TOL = 2e-6
L2_GAP = 1e-5


def _float_sets(p, k, d, seed, device, valid_share=0.9):
    """Non-negative unit-norm descriptors as SIFT's: B holds noisy copies of
    A's rows in another order for half its rows, the rest fresh; masks with
    `valid_share` valid."""
    g = torch.Generator().manual_seed(seed)
    norm = lambda x: x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    a = norm(torch.randn((p, k, d), generator=g).abs())
    b = norm(torch.randn((p, k, d), generator=g).abs())
    perm = torch.randperm(k, generator=g)
    half = perm[: k // 2]
    b[:, half] = norm((a[:, torch.roll(half, 1)] + 0.05 * torch.randn((p, k // 2, d), generator=g)).abs())
    va = torch.rand((p, k), generator=g) < valid_share
    vb = torch.rand((p, k), generator=g) < valid_share
    return tuple(t.contiguous().to(device) for t in (a, b, va, vb))


def _twin_in_blocks(a, b, va, vb, block=8):
    """The plain twin on the card (TF32 off) a few pairs at a time, with each
    row's and column's gap between its best and second best."""
    outs, col_gaps = [], []
    for s in range(0, a.shape[0], block):
        sl = slice(s, s + block)
        outs.append(cuda_l2match.l2_match_reductions_plain(a[sl], b[sl], va[sl], vb[sl]))
        two = torch.topk(cuda_l2match.l2_matrix(a[sl], b[sl], va[sl], vb[sl]), 2, dim=-2, largest=False).values
        col_gaps.append(two[:, 1] - two[:, 0])
    d1, i1, d2, cb = (torch.cat(x) for x in zip(*outs))
    return (d1, i1, d2, cb), d2 - d1, torch.cat(col_gaps)


def _assert_l2_close(got, want, row_gap, col_gap):
    d1, i1, d2, cb = got
    w1, wi, w2, wc = want
    assert float((d1 - w1).abs().max()) <= L2_DIST_TOL
    assert float((d2 - w2).abs().max()) <= L2_DIST_TOL
    rows, cols = row_gap > L2_GAP, col_gap > L2_GAP
    assert torch.equal(i1[rows], wi[rows]) and torch.equal(cb[cols], wc[cols])
    return int(rows.sum()), int(cols.sum())


@pytest.mark.parametrize("p,k,d", [(8, 8192, 128), (143, 8192, 128), (8, 4096, 64), (5, 1000, 128), (3, 77, 64)])
def test_l2_match_kernel_equals_twin(cuda_device, p, k, d):
    """The kernel against its plain twin (l2_matrix and argmins, TF32 off) at
    the SIFT cell's shapes (8 and 143 pairs of 8192), SURF's 64-d, and ragged
    K: distances within L2_DIST_TOL, indices equal off near-ties."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b, va, vb = _float_sets(p, k, d, seed=p + k + d, device=cuda_device)
    before = cuda_l2match.LAUNCHES
    got = cuda_l2match.l2_match_reductions_cuda(a, b, va, vb)
    torch.cuda.synchronize()
    assert cuda_l2match.LAUNCHES == before + 1
    want, row_gap, col_gap = _twin_in_blocks(a, b, va, vb)
    n_rows, n_cols = _assert_l2_close(got, want, row_gap, col_gap)
    assert n_rows > 0.8 * p * k and n_cols > 0.8 * p * k  # all but the invalid tenth and near-ties


def test_l2_match_kernel_breaks_ties_to_the_lowest_index(cuda_device):
    """Exact ties: every column of B and every row of A repeated 600 places
    further on give equal distances bit for bit, and the kernel keeps the
    lower index of each tie, as the twin's argmin does."""
    a, b, va, vb = _float_sets(2, 1200, 128, seed=7, device=cuda_device, valid_share=1.0)
    src = torch.arange(0, 600, device=cuda_device)
    b[:, 600 + src] = b[:, src]
    a[:, 600 + src] = a[:, src]
    d1, i1, d2, cb = cuda_l2match.l2_match_reductions_cuda(a, b, va, vb)
    want = cuda_l2match.l2_match_reductions_plain(a, b, va, vb)
    assert float((d1 - want[0]).abs().max()) <= L2_DIST_TOL
    assert bool((i1 < 600).all()) and bool((cb < 600).all())
    assert torch.equal(d1, d2)  # every row's best appears twice


@pytest.mark.parametrize("k", [100, 512])
def test_l2_match_kernel_all_invalid_lines(cuda_device, k):
    """A pair with every row invalid, one with every column invalid, and
    lines partly invalid: an entry of an invalid line is BIG exactly, a line
    with no valid entry gives BIG at index 0, as in the matrix form."""
    a, b, va, vb = _float_sets(3, k, 128, seed=k, device=cuda_device, valid_share=0.7)
    va[0] = False
    vb[1] = False
    got = cuda_l2match.l2_match_reductions_cuda(a, b, va, vb)
    want, row_gap, col_gap = _twin_in_blocks(a, b, va, vb)
    _assert_l2_close(got, want, row_gap, col_gap)
    d1, i1, d2, cb = got
    big = cuda_match.BIG
    assert bool((d1[0] == big).all() and (i1[0] == 0).all() and (d2[0] == big).all() and (cb[0] == 0).all())
    assert bool((d1[1] == big).all() and (i1[1] == 0).all() and (cb[1] == 0).all())
    assert torch.equal(d1[2] == big, ~va[2]) and bool((cb[2][~vb[2]] == 0).all())


def test_l2_match_kernel_repeats_bit_for_bit(cuda_device):
    """Two launches on the same sets give the same bits: the sums run in a
    fixed order and the column keys' minimum does not depend on which CTA
    reaches the key first."""
    a, b, va, vb = _float_sets(16, 8192, 128, seed=3, device=cuda_device)
    first = cuda_l2match.l2_match_reductions_cuda(a, b, va, vb)
    second = cuda_l2match.l2_match_reductions_cuda(a, b, va, vb)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_l2_match_tolerances_refuse_a_tf32_twin(cuda_device):
    """The tolerances are tight enough to tell precision: the twin's matmul
    in TF32 (10-bit operands) in the kernel's place fails them."""
    a, b, va, vb = _float_sets(8, 8192, 128, seed=11, device=cuda_device)
    got = cuda_l2match.l2_match_reductions_cuda(a, b, va, vb)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32, _, _ = _twin_in_blocks(a, b, va, vb)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    with pytest.raises(AssertionError):
        assert float((got[0] - tf32[0]).abs().max()) <= L2_DIST_TOL
        assert float((got[2] - tf32[2]).abs().max()) <= L2_DIST_TOL


def test_l2_match_wrapper_checks_its_inputs(cuda_device):
    a, b, va, vb = _float_sets(2, 256, 128, seed=1, device=cuda_device)
    call = cuda_l2match.l2_match_reductions_cuda
    cut = lambda t: t[..., :96].contiguous()
    strided = a.transpose(0, 1).contiguous().transpose(0, 1)
    for bad in [(a, b.cpu(), va, vb), (a.double(), b.double(), va, vb), (cut(a), cut(b), va, vb),
                (strided, b, va, vb), (a, b, va.to(torch.uint8), vb)]:
        with pytest.raises(ValueError):
            call(*bad)


def test_float_match_on_cuda_runs_the_kernel_without_a_k_by_k_matrix(cuda_device):
    """matcher.match on float sets at the SIFT cell's K: one kernel launch,
    and the card's peak memory rises by far less than one (P, K, K) float32
    matrix; the matches equal the CPU twin's off near-ties."""
    from droplet_visual_odometry_tpu_torch.frontend import matcher

    p, k = 4, 8192
    a, b, va, vb = _float_sets(p, k, 128, seed=5, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = cuda_l2match.LAUNCHES
    m = matcher.match(a, b, va, vb, mode="ratio", ratio=0.75)
    torch.cuda.synchronize()
    assert cuda_l2match.LAUNCHES == before + 1
    assert torch.cuda.max_memory_allocated() - base < p * k * k * 4 / 64
    want, row_gap, _ = _twin_in_blocks(a, b, va, vb, block=2)
    ref_ok = (want[0] < 0.75 * 0.75 * want[2]) & (want[0] < cuda_match.BIG)
    sure = (row_gap > L2_GAP) & ((want[0] - 0.5625 * want[2]).abs() > 1e-5)
    assert torch.equal(m.valid[sure], ref_ok[sure]) and torch.equal(m.idx[sure], want[1][sure].to(torch.int64))


def test_vo_match_stage_counts_the_l2_kernel_on_cuda(cuda_device):
    """The captured VO program marks `vo.match`: every replay of a SIFT
    sequence records its pairs, keypoints, D = 128 and l2_kernel = 1 (the
    float match ran in csrc/l2_match.cu), an ORB sequence's D = 8 words and
    l2_kernel = 0."""
    import time

    from droplet_visual_odometry_tpu_torch.estimation.vo import run_sequence
    from droplet_visual_odometry_tpu_torch.utils import profiling

    seq = _stream_sequence()
    frames = pipeline.make_preprocessor(seq, "cuda")(seq.frames)
    K = pipeline.effective_K(seq)
    corners = pipeline.effective_marker_corners(seq, K)
    sift = VOConfig(frontend="sift", n_keypoints=1024, match_mode="ratio", scale_mode="hold")
    for cfg, dim, l2 in ((sift, 128, 1), (VOConfig(), 8, 0)):
        args = (frames, corners, seq.marker_present, seq.marker_poses[0], K, seq.real_marker_length, cfg)
        run_sequence(*args, seed=1)  # the capture
        t0 = time.perf_counter()
        for seed in (2, 3):
            run_sequence(*args, seed=seed)
            torch.cuda.synchronize()
            profiling.RECORDER.resolve()  # as run_experiment does once it has read a replay's outputs
        stages = [r for r in profiling.snapshot(t0) if r.name == "vo.match"]
        assert len(stages) == 2 and all(r.dev_t1 > r.dev_t0 for r in stages)
        assert all(r.attrs == dict(pairs=len(seq) - 1, keypoints=cfg.n_keypoints, dim=dim, l2_kernel=l2)
                   for r in stages)
