"""The pose graph's block-Jacobi PCG: the CUDA kernel csrc/pose_graph_pcg.cu and its plain twin.

Replaces no TPU kernel: the JAX package runs this CG loop as XLA ops in its
compiled Gauss-Newton step. On the card the op-by-op loop (`pcg_plain`)
issues about 36 kernels a CG iteration; the kernel runs all of one GN
step's iterations in one launch, on one SM or on the SMs of one thread
block cluster, with the iterates, the edge blocks and M^-1 on chip, and
sums in a fixed order (see the source's header). Bound on the H100: the
chain of barriers inside an iteration; the bytes (B and M^-1 read once) and
FLOPs are far below it.

    x, live = pcg_cuda(B, edge_i, edge_j, b, Minv, damping, iters, tol)

solves H x = b with H p = gm * sum_e (+-) B_e (pm_i - pm_j) + damping * pm,
pm = gm * p, gm the gauge mask of node 0 (`matvec_local`). live is the ()
int32 count of CG iterations run. Dispatch: CPU tensors go to `pcg_plain`
(`pcg` with that product, op by op); CUDA tensors go to the kernel, or the
call raises. `plan` says on how many blocks the kernel takes a graph, and
`fits` whether it takes it at all; backend/pose_graph chooses its path with
it. The CG loop `pcg` and the edge-local product `hx_local` are defined
here once: backend/pose_graph runs `pcg` with its edge-sharded product over
a mesh.
"""

from __future__ import annotations

import torch

from droplet_visual_odometry_tpu_torch.ops import build

MAX_SMEM = 232_448  # shared memory one block may take on the H100 (227 KB)
MAX_CLUSTER = 8  # blocks of one cluster: the portable cluster size
MAX_WARPS = 32
MAX_ROWS = 5  # node rows a thread holds

LAUNCHES = 0  # kernel launches made by pcg_cuda


def gauge_mask(M: int, like: torch.Tensor) -> torch.Tensor:
    """(M, 6) multiplier fixing node 0 (the gauge)."""
    keep = (torch.arange(M, device=like.device) >= 1).to(like.dtype)
    return keep[:, None] * torch.ones((1, 6), dtype=like.dtype, device=like.device)


def hx_local(B: torch.Tensor, ei: torch.Tensor, ej: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Edge-local part of the Hessian-vector product (no damping/gauge)."""
    y = torch.einsum("eab,eb->ea", B, x[ei] - x[ej])  # (E, 6)
    return torch.zeros_like(x).index_add_(0, ei, y).index_add_(0, ej, -y)


def matvec_local(B: torch.Tensor, ei: torch.Tensor, ej: torch.Tensor, damping: float, M: int):
    """The one-device H p of the GN step's normal system, gauge held."""
    gm = gauge_mask(M, B)

    def matvec(x):
        x = x * gm
        return hx_local(B, ei, ej, x) * gm + damping * x

    return matvec


def pcg(matvec, b: torch.Tensor, Minv: torch.Tensor, iters: int, tol: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-preconditioned CG: solve H x = b with M^-1 given as (M, 6, 6).

    The reference's while loop (k < iters and |r|^2 > tol |b|^2) without a
    host round trip: all `iters` steps are issued, and once the test fails a
    device-side flag sets the step length to 0. x and r then stay as they
    were (x + 0 p = x for finite p), z = M^-1 r is recomputed from the same r
    to the same bits, and p, which no longer reaches x, grows at most by z
    per step; so x is the loop's. Returns (x, live): live () int32 on the
    device, the steps whose flag was set, i.e. the loop's iteration count."""

    def apply_minv(r):
        return torch.einsum("mab,mb->ma", Minv, r)

    x = torch.zeros_like(b)
    r = b
    z = apply_minv(r)
    p = z
    stop = tol * torch.clamp(torch.sum(b * b), min=1e-30)
    active = torch.sum(r * r) > stop
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    flags = []
    for _ in range(iters):
        flags.append(active)
        Hp = matvec(p)
        rz = torch.sum(r * z)
        alpha = torch.where(active, rz / torch.clamp(torch.sum(p * Hp), min=1e-30), zero)
        x = x + alpha * p
        r = r - alpha * Hp
        z_new = apply_minv(r)
        beta = torch.sum(r * z_new) / torch.clamp(rz, min=1e-30)
        p = z_new + beta * p
        z = z_new
        active = active & (torch.sum(r * r) > stop)
    live = torch.stack(flags).sum(dtype=torch.int32) if flags else torch.zeros((), dtype=torch.int32, device=b.device)
    return x, live


def smem_bytes(mb: int, eb: int, e: int) -> int:
    """Shared memory one block takes for its mb node slots and eb edge slots
    of a graph of e edges (the source's smem_bytes): B and M^-1 (36 floats
    an edge, a node), p and y, 96 floats of partial sums, three ints a node
    and one for a flag, and 16-bit edge ends and incidence lists."""
    return 4 * (42 * eb + 42 * mb + 96) + 4 * (3 * mb + 2) + 2 * (2 * eb + 2 * e)


def plan(m: int, e: int) -> tuple[int, int] | None:
    """(blocks, warps a block) of the smallest cluster whose blocks take a
    graph of m nodes and e edges: five nodes a warp, at most five node rows
    a thread and MAX_SMEM a block; None past MAX_CLUSTER blocks."""
    if m < 1 or e < 0:
        return None
    for c in range(1, MAX_CLUSTER + 1):
        w = min(MAX_WARPS, -(-max(m, e) // (5 * c)))
        s, sc = 5 * w, 5 * w * c
        r = -(-m // sc)
        if r <= MAX_ROWS and smem_bytes(min(m, r * s), min(e, -(-e // sc) * s), e) <= MAX_SMEM:
            return c, w
    return None


def fits(m: int, e: int, dtype: torch.dtype) -> bool:
    """True when the kernel takes a float32 graph of m nodes and e edges."""
    return dtype == torch.float32 and plan(m, e) is not None


def pcg_plain(B: torch.Tensor, edge_i: torch.Tensor, edge_j: torch.Tensor, b: torch.Tensor, Minv: torch.Tensor,
              damping: float, iters: int, tol: float) -> tuple[torch.Tensor, torch.Tensor]:
    """`pcg` with `matvec_local`, op by op: the kernel's plain twin, and the
    one-device CG wherever the kernel does not run (the CPU, float64, a
    graph past one cluster)."""
    return pcg(matvec_local(B, edge_i, edge_j, damping, b.shape[0]), b, Minv, iters, tol)


def pcg_cuda(B: torch.Tensor, edge_i: torch.Tensor, edge_j: torch.Tensor, b: torch.Tensor, Minv: torch.Tensor,
             damping: float, iters: int, tol: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(E, 6, 6) blocks, (E,) int64 edge ends, (M, 6) rhs, (M, 6, 6) M^-1 ->
    (x (M, 6), live () int32). CUDA tensors run the kernel; CPU tensors run
    the plain twin."""
    tensors = (B, edge_i, edge_j, b, Minv)
    if all(t.device.type == "cpu" for t in tensors):
        return pcg_plain(B, edge_i, edge_j, b, Minv, damping, iters, tol)
    if any(t.dtype != torch.float32 for t in (B, b, Minv)):
        raise ValueError(f"pcg_cuda: B, b and Minv must be float32, got {B.dtype}, {b.dtype}, {Minv.dtype}")
    if edge_i.dtype != torch.int64 or edge_j.dtype != torch.int64:
        raise ValueError(f"pcg_cuda: edge ends must be int64, got {edge_i.dtype}, {edge_j.dtype}")
    m = b.shape[0] if b.dim() == 2 else -1
    e = B.shape[0] if B.dim() == 3 else -1
    if b.shape != (m, 6) or B.shape != (e, 6, 6) or edge_i.shape != (e,) or edge_j.shape != (e,) \
            or Minv.shape != (m, 6, 6):
        raise ValueError(
            f"pcg_cuda: need B (E, 6, 6), edge ends (E,), b (M, 6) and Minv (M, 6, 6); got "
            f"{tuple(B.shape)}, {tuple(edge_i.shape)}, {tuple(edge_j.shape)}, {tuple(b.shape)}, {tuple(Minv.shape)}"
        )
    loose = [n for n, t in zip(("B", "edge_i", "edge_j", "b", "Minv"), tensors) if not t.is_contiguous()]
    if loose:
        raise ValueError(f"pcg_cuda: inputs must be contiguous; {loose} are not")
    blocks = plan(m, e)
    if blocks is None:
        raise ValueError(f"pcg_cuda: a graph of {m} nodes and {e} edges does not fit one cluster of "
                         f"{MAX_CLUSTER} blocks")
    dev = b.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"pcg_cuda: tensors on {[str(t.device) for t in tensors]}")

    x = torch.empty((m, 6), dtype=torch.float32, device=dev)
    live = torch.empty((), dtype=torch.int32, device=dev)
    global LAUNCHES
    lib = build.library()
    status = lib.dvo_pose_graph_pcg(
        B.data_ptr(), edge_i.data_ptr(), edge_j.data_ptr(), b.data_ptr(), Minv.data_ptr(), x.data_ptr(),
        live.data_ptr(), m, e, float(damping), int(iters), float(tol), *blocks, build.current_stream_ptr(dev),
    )
    LAUNCHES += 1
    build.check(status, "dvo_pose_graph_pcg")
    return x, live
