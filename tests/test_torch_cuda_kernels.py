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
from droplet_visual_odometry_tpu_torch.frontend import features, orb
from droplet_visual_odometry_tpu_torch.ops import cuda_fast, cuda_match, cuda_patches

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


@pytest.mark.parametrize("h,w", [(96, 128), (101, 67), (470, 626)])
@pytest.mark.parametrize("thr,arc", [(20.0, 9), (10.0, 12), (5.0, 3), (20.0, 16), (20.0, 17)])
def test_fast_score_kernel_equals_plain(cuda_device, h, w, thr, arc):
    """Integer images: every excess sum is exact, so kernel == plain bit for
    bit; sizes off the 32x8 tile exercise the clamped halo and ragged edge."""
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


def test_extract_patches_kernel_equals_plain(cuda_device):
    """A pure copy: exact, including origins on every edge of the image."""
    n, h, w, m = 3, 120, 150, 500
    imgs = torch.rand((n, h, w), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    rng = np.random.default_rng(1)
    o = np.stack([rng.integers(0, n, m), rng.integers(0, h - 36, m), rng.integers(0, w - 36, m)], axis=1)
    o[:4, 1:] = [[0, 0], [h - 37, w - 37], [0, w - 37], [h - 37, 0]]
    origins = torch.from_numpy(o.astype(np.int32)).to(cuda_device)
    before = cuda_patches.LAUNCHES
    out = cuda_patches.extract_patches_cuda(imgs, origins, check=True)
    torch.cuda.synchronize()
    assert cuda_patches.LAUNCHES == before + 1
    assert torch.equal(out, cuda_patches.extract_patches_plain(imgs, origins))


def test_extract_patches_kernel_checks_origins(cuda_device):
    imgs = torch.zeros((2, 64, 64), device=cuda_device)
    with pytest.raises(ValueError, match="out of range"):
        cuda_patches.extract_patches_cuda(imgs, torch.tensor([[0, 28, 0]], dtype=torch.int32, device=cuda_device), check=True)
    with pytest.raises(ValueError):
        cuda_patches.extract_patches_cuda(imgs, torch.zeros((4, 3), dtype=torch.int64, device=cuda_device))


def _descriptors(p, k, seed, ties):
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 2**32, size=(p, k, 8), dtype=np.uint32)
    if ties:  # repeated rows, distances from one word only: equal minima everywhere
        desc = desc[:, rng.integers(0, max(k // 8, 1), size=k)]
        desc[..., 1:] = 0
    valid = rng.uniform(size=(p, k)) > 0.2
    return torch.from_numpy(desc.view(np.int32).copy()), torch.from_numpy(valid)


@pytest.mark.parametrize("k,ties", [(100, True), (512, False), (512, True), (2048, False), (2048, True)])
def test_match_reductions_kernel_equals_plain(cuda_device, k, ties):
    """Integer distances and lowest-index ties on both sides: exact equality
    of d1, i1, d2 and col_best (the atomicMin order cannot change a min)."""
    da, va = _descriptors(3, k, seed=k, ties=ties)
    db, vb = _descriptors(3, k, seed=k + 1, ties=ties)
    args = [t.to(cuda_device) for t in (da, db, va, vb)]
    before = cuda_match.LAUNCHES
    out = cuda_match.match_reductions_cuda(*args)
    torch.cuda.synchronize()
    assert cuda_match.LAUNCHES == before + 1
    for got, want in zip(out, cuda_match.match_reductions_plain(*args)):
        assert torch.equal(got, want)


def test_slice_on_cuda_launches_every_kernel(cuda_device):
    """run_experiment on the card goes through all three kernels (one FAST
    and one patch launch per pyramid level, one batched match) and agrees
    with the port's CPU run: level 0 is exact, the bf16 resize sums in
    another order on the card, so match counts may move by a few in total
    (2% bound). The ATE is held to 3 cm: the port's CPU runs of this
    sequence give 7-13 mm over RANSAC seeds 0-2, and the card draws other
    random samples."""
    seq = synthetic.render_sequence(synthetic.SyntheticConfig(n_frames=8, width=640, height=480, n_landmarks=350))
    cpu = pipeline.run_experiment(seq, VOConfig(), device="cpu")
    for mod in (cuda_fast, cuda_patches, cuda_match):
        mod.LAUNCHES = 0
    gpu = pipeline.run_experiment(seq, VOConfig(), device=cuda_device)
    assert (cuda_fast.LAUNCHES, cuda_patches.LAUNCHES, cuda_match.LAUNCHES) == (4, 4, 1)
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
