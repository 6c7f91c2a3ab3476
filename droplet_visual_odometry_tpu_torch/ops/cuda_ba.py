"""The windowed BA's Levenberg-Marquardt loop: the CUDA kernel csrc/windowed_ba.cu and its plain twin.

Replaces no TPU kernel: the JAX package compiles run_ba with XLA. On the
card the op-by-op loop (backend/ba.run_ba_eager, the plain twin here) issues
about 280 kernels an LM step, so the captured replay of a window's ten steps
is bound by its ~2,800 graph nodes; the kernel runs all the steps, their
accept or reject, the costs and the RMS in one launch, on one SM or on the
SMs of one thread block cluster, in float64, summed in a fixed order (see
the source's header). Bound on the H100: the chain of barriers of each LM
step (the landmark chunks, the LDL^T's panels, two cluster barriers); the
FLOPs and bytes are far below it.

    poses, points, initial_cost, final_cost, rms_px = run_ba_cuda(window, cfg)

Dispatch: CPU tensors go to `run_ba_plain` (run_ba_eager, op by op); CUDA
tensors go to the kernel, or the call raises. `plan` says on how many
blocks the kernel takes a window, and `fits` whether it takes it at all;
backend/ba chooses its path with it.
"""

from __future__ import annotations

import torch

from droplet_visual_odometry_tpu_torch.ops import build

THREADS = 256  # a block's threads (the source's kThreads)
MAX_SMEM = 232_448  # shared memory one block may take on the H100 (227 KB)
MAX_CLUSTER = 8  # blocks of one cluster: the portable cluster size
SCRATCH = 15  # doubles of global scratch a landmark

LAUNCHES = 0  # kernel launches made by run_ba_cuda


def smem_bytes(W: int) -> int:
    """Shared memory one block takes for a window of W poses (the source's
    smem_doubles): 51 doubles an observation of a chunk of THREADS // W
    landmarks (or, later in a step, the units' staging, or the 6W x (6W + 1)
    system with the summed units), the block's partial sums (36 doubles a
    unit: W (W + 1) / 2 pose pairs and W poses), 12 doubles a chunk
    landmark, the poses twice, the camera step, the system's D^-1 and the
    sums of the cost."""
    n, units, chunk = 6 * W, W * (W + 1) // 2 + W, THREADS // W
    big = max(THREADS * 51, THREADS * 36, n * (n + 1) + units * 36)
    return 8 * (big + units * 36 + chunk * 12 + 2 * W * 16 + 2 * n + 4 + THREADS // 32 * 4)


def plan(W: int, L: int) -> int | None:
    """The blocks of the cluster that takes a window of W poses and L
    landmarks: MAX_CLUSTER, or one a landmark below that (on the H100 more
    blocks were faster at every L from 100 to 1000: the landmark work
    splits, the serial solve runs in every block alike); None where a unit
    per thread or one block's shared memory does not suffice (W > 18)."""
    if W < 1 or L < 1 or W * (W + 3) // 2 > THREADS or smem_bytes(W) > MAX_SMEM:
        return None
    return min(MAX_CLUSTER, L)


def fits(W: int, L: int, dtype: torch.dtype) -> bool:
    """True when the kernel takes a float64 window of W poses and L landmarks."""
    return dtype == torch.float64 and plan(W, L) is not None


def run_ba_plain(window, cfg):
    """The kernel's plain twin: backend/ba.run_ba_eager, the LM loop op by op."""
    from droplet_visual_odometry_tpu_torch.backend import ba  # backend/ba imports this module

    return ba.run_ba_eager(window, cfg)


def run_ba_cuda(window, cfg) -> tuple[torch.Tensor, ...]:
    """A backend/ba.BAWindow and BAConfig -> (poses (W, 4, 4), points (L, 3),
    initial_cost, final_cost, rms_px), as run_ba_eager returns them. CUDA
    tensors run the kernel (float64, a bool mask, contiguous, one device;
    the outputs are views of one buffer); CPU tensors run the plain twin."""
    poses, points, obs_uv, obs_mask, K = window
    tensors = (poses, points, obs_uv, obs_mask, K)
    if all(t.device.type == "cpu" for t in tensors):
        return tuple(run_ba_plain(window, cfg))
    names = ("poses", "points", "obs_uv", "K")
    wrong = [f"{n} {t.dtype}" for n, t in zip(names, (poses, points, obs_uv, K)) if t.dtype != torch.float64]
    if wrong or obs_mask.dtype != torch.bool:
        raise ValueError(f"run_ba_cuda: poses, points, obs_uv and K must be float64 and obs_mask bool; got "
                         f"{wrong + [f'obs_mask {obs_mask.dtype}']}")
    W = poses.shape[0] if poses.dim() == 3 else -1
    L = points.shape[0] if points.dim() == 2 else -1
    if poses.shape != (W, 4, 4) or points.shape != (L, 3) or obs_uv.shape != (W, L, 2) \
            or obs_mask.shape != (W, L) or K.shape != (3, 3):
        raise ValueError(
            f"run_ba_cuda: need poses (W, 4, 4), points (L, 3), obs_uv (W, L, 2), obs_mask (W, L) and K (3, 3); "
            f"got {tuple(poses.shape)}, {tuple(points.shape)}, {tuple(obs_uv.shape)}, {tuple(obs_mask.shape)}, "
            f"{tuple(K.shape)}")
    loose = [n for n, t in zip(("poses", "points", "obs_uv", "obs_mask", "K"), tensors) if not t.is_contiguous()]
    if loose:
        raise ValueError(f"run_ba_cuda: inputs must be contiguous; {loose} are not")
    blocks = plan(W, L)
    if blocks is None:
        raise ValueError(f"run_ba_cuda: a window of {W} poses and {L} landmarks does not fit the kernel")
    dev = poses.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"run_ba_cuda: tensors on {[str(t.device) for t in tensors]}")

    out = torch.empty(W * 16 + L * 3 + 3, dtype=torch.float64, device=dev)
    scratch = torch.empty(L * SCRATCH, dtype=torch.float64, device=dev)
    global LAUNCHES
    lib = build.library()
    status = lib.dvo_windowed_ba(
        poses.data_ptr(), points.data_ptr(), obs_uv.data_ptr(), obs_mask.data_ptr(), K.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), W, L, int(cfg.iters), float(cfg.init_lambda), float(cfg.lambda_up),
        float(cfg.lambda_down), float(cfg.huber_px), float(cfg.min_depth), int(cfg.n_fixed), blocks,
        build.current_stream_ptr(dev),
    )
    LAUNCHES += 1
    build.check(status, "dvo_windowed_ba")
    tail = W * 16 + L * 3
    return out[: W * 16].view(W, 4, 4), out[W * 16 : tail].view(L, 3), out[tail], out[tail + 1], out[tail + 2]
