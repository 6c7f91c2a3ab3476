"""The streamed backends' keyframe fetch (pipeline.HostFetcher): host
frames gathered a block at a time into two reused staging blocks, copied
to the device and remapped there, equal bit for bit to preprocessing the
whole gathered stack.

On the CPU: ndarray, np.memmap and StoreFrames sources; index lists of
one frame, one block less one, one block, one block and one, and two and
a half blocks, each with a repeated index; a distorted camera (the remap)
and an undistorted one (the cast).

On the card (marker `cuda`, skipped here; run it there with
`python -m pytest tests/test_torch_fetch.py -m cuda -q --noconftest -o addopts= -p no:cacheprovider`):
at 1440x1080 the fetch equals its eager twin, its staging blocks are
page-locked, and a second fetch reuses the same host blocks.
This file imports no jax.
"""

from __future__ import annotations

import contextlib
import time
import types

import numpy as np
import pytest
import torch

from droplet_visual_odometry_tpu_torch import pipeline
from droplet_visual_odometry_tpu_torch.core import camera as camera_mod
from droplet_visual_odometry_tpu_torch.data import native_store
from droplet_visual_odometry_tpu_torch.utils import profiling

N, H, W = 16, 24, 32
BLOCK = 4  # frames a staging block holds in the CPU cases


def preprocessor(distorted: bool, width: int, height: int, device):
    dist = [-0.12, 0.05, 0.001, -0.002, 0.0] if distorted else None
    cam = camera_mod.make_camera(0.9 * width, 0.9 * width, width / 2 - 0.3, height / 2 + 0.2, dist, width, height)
    return pipeline.make_preprocessor(types.SimpleNamespace(camera=cam), device)


@pytest.fixture(scope="module")
def host_frames():
    return np.random.default_rng(5).integers(0, 256, (N, H, W), dtype=np.uint8)


def source(kind: str, frames: np.ndarray, tmp_path, stack):
    if kind == "ndarray":
        return frames
    if kind == "memmap":
        np.save(tmp_path / "frames.npy", frames)
        return np.load(tmp_path / "frames.npy", mmap_mode="r")
    path = str(tmp_path / "frames.vost")
    native_store.write_store(path, frames, np.arange(N, dtype=np.float64))
    return stack.enter_context(native_store.StoreReader(path)).frames()


@pytest.mark.parametrize("distorted", [True, False], ids=["remap", "cast"])
@pytest.mark.parametrize("kind", ["ndarray", "memmap", "store"])
@pytest.mark.parametrize("n_idx", [1, BLOCK - 1, BLOCK, BLOCK + 1, 5 * BLOCK // 2])
def test_blocked_fetch_equals_the_whole_stack(host_frames, tmp_path, monkeypatch, distorted, kind, n_idx):
    """fetch(idx) is preprocess(host_frames[idx]) bit for bit, through two
    staging blocks of BLOCK frames, with the counts on the enclosing span."""
    monkeypatch.setattr(pipeline, "FETCH_BLOCK_BYTES", BLOCK * H * W + H * W - 1)
    idx = np.random.default_rng(n_idx).integers(0, N, n_idx)
    if n_idx > 1:
        idx[-1] = idx[0]  # a repeated index
    pre = preprocessor(distorted, W, H, "cpu")
    want = pre(host_frames[idx])
    with contextlib.ExitStack() as stack:
        fetch = pipeline.HostFetcher(source(kind, host_frames, tmp_path, stack), pre, torch.device("cpu"))
        t0 = time.perf_counter()
        with profiling.span("test.fetch"):
            got = fetch(idx)
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape == (n_idx, H, W)
    assert torch.equal(got, want)
    assert fetch.block == BLOCK and [tuple(b.shape) for b in fetch.staging] == [(BLOCK, H, W)] * 2
    n_blocks = -(-n_idx // BLOCK)
    (outer,) = [r for r in profiling.snapshot(t0) if r.name == "test.fetch"]
    assert outer.attrs == dict(frames=n_idx, blocks=n_blocks, pinned=0)


def test_fetch_rejects_an_index_out_of_range(host_frames):
    fetch = pipeline.HostFetcher(host_frames, preprocessor(False, W, H, "cpu"), torch.device("cpu"))
    for bad in ([0, N], [-N - 1]):
        with pytest.raises(IndexError):
            fetch(bad)
    assert torch.equal(fetch([-1, 0]), torch.as_tensor(host_frames[[-1, 0]], dtype=torch.float32))


# -- on the card ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: page-locked staging and asynchronous copies exist on the card only")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fetch_on_the_card_is_pinned_reused_and_exact(cuda_device):
    """At 1440x1080 (43 frames a block) the fetch of 100 keyframes equals
    the eager whole-stack preprocess bit for bit; its two staging blocks
    are page-locked, and a second fetch refills the same host blocks."""
    height, width = 1080, 1440
    frames = np.random.default_rng(1).integers(0, 256, (120, height, width), dtype=np.uint8)
    pre = preprocessor(True, width, height, cuda_device)
    fetch = pipeline.HostFetcher(frames, pre, cuda_device)
    rng = np.random.default_rng(2)
    idx = np.sort(rng.choice(120, 100, replace=False))
    idx[7] = idx[6]
    assert fetch.block == 43
    assert torch.equal(fetch(idx), pre(frames[idx]))
    assert len(fetch.staging) == 2 and all(b.is_pinned() for b in fetch.staging)
    ptrs = [b.data_ptr() for b in fetch.staging]
    idx2 = rng.integers(0, 120, 90)
    assert torch.equal(fetch(idx2), pre(frames[idx2]))
    assert [b.data_ptr() for b in fetch.staging] == ptrs
