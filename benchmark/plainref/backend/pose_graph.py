"""Pose-graph optimisation — port of droplet_visual_odometry_tpu/backend/pose_graph.py.

Nodes are keyframe poses (world_T_node), edges relative-pose measurements.
Gauss-Newton on the se(3) residual r_e = log(Z_e^-1 X_i^-1 X_j) under left
twists X <- exp(xi) X, with the reference's analytic block Jacobians
J_j = Jr^-1(r) Adj(X_j^-1), J_i = -J_j, and Jr^-1(r) ~ I + ad(r)/2. Edge
weights are scalar (E,), diagonal (E, 6) or full (E, 6, 6) information.

The normal system is never formed: per-edge blocks B_e = J_j^T W J_j and the
block diagonal give a block-Jacobi preconditioned CG whose Hessian-vector
product is a gather, a batched 6x6 matvec and a scatter-add. The scatter-adds
are `index_add_`, which on CUDA adds in no fixed order, so a result on the
card can differ from run to run in the last f32 bits: tests hold it to a
stated tolerance, never to bit equality. The CG stop test runs on the device
(see `_pcg`), so `optimize` makes no host round trip. solver='dense' is
the Cholesky-free dense solve kept for cross-checking small graphs.

Edges are padded arrays with a weight mask: a zero-weight edge adds nothing
to cost, gradient or preconditioner. Edge indices are int64 (the
reference's int32 values).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from plainref.core import se3


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    iters: int = 10
    damping: float = 1e-6
    solver: str = "pcg"  # 'pcg' (block-sparse, O(edges)) | 'dense'
    cg_iters: int = 100  # CG iteration cap per GN step
    cg_tol: float = 1e-8  # relative residual-norm^2 stop


class PoseGraph(NamedTuple):
    poses: torch.Tensor  # (M, 4, 4) node poses (world_T_node)
    edge_i: torch.Tensor  # (E,) int64 source node
    edge_j: torch.Tensor  # (E,) int64 target node
    edge_meas: torch.Tensor  # (E, 4, 4) measured node_i_T_node_j
    edge_weight: torch.Tensor  # (E,) | (E, 6) | (E, 6, 6) information (0 = padding)


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def weight_matrices(edge_weight: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Normalise scalar / diagonal / full edge weights to (E, 6, 6)."""
    w = torch.as_tensor(edge_weight).to(dtype)
    if w.dim() == 1:  # scalar per edge -> w * I6
        return w[:, None, None] * _eye(6, w)
    if w.dim() == 2:  # diagonal per edge
        return torch.diag_embed(w)
    if w.dim() == 3:
        return w
    raise ValueError(f"edge_weight must be (E,), (E,6) or (E,6,6); got {tuple(w.shape)}")


def _edge_residuals(poses: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """(E, 6) unweighted residuals r_e = log(Z^-1 X_i^-1 X_j)."""
    rel = se3.inverse(poses[graph.edge_i]) @ poses[graph.edge_j]
    return se3.se3_log(se3.inverse(graph.edge_meas) @ rel)


def cost(graph: PoseGraph) -> torch.Tensor:
    r = _edge_residuals(graph.poses, graph)
    W = weight_matrices(graph.edge_weight, graph.poses.dtype)
    return torch.sum(r * torch.einsum("eab,eb->ea", W, r))


def _edge_blocks(poses: torch.Tensor, graph: PoseGraph) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-edge weighted normal blocks (B, g): B = J_j^T W J_j (E, 6, 6) and
    g = J_j^T W r (E, 6). With J_i = -J_j they give every H block and
    gradient entry of the edge: H_ii = H_jj = B, H_ij = H_ji = -B,
    b_i = +g, b_j = -g."""
    r = _edge_residuals(poses, graph)
    Jr_inv = _eye(6, r) + 0.5 * se3.ad(r)
    Jj = Jr_inv @ se3.adjoint(se3.inverse(poses[graph.edge_j]))
    W = weight_matrices(graph.edge_weight, poses.dtype)
    WJj = W @ Jj
    B = Jj.transpose(-1, -2) @ WJj
    g = torch.einsum("ekh,ek->eh", WJj, r)
    return B, g


def _gauge_mask(M: int, like: torch.Tensor) -> torch.Tensor:
    """(M, 6) multiplier fixing node 0 (the gauge)."""
    keep = (torch.arange(M, device=like.device) >= 1).to(like.dtype)
    return keep[:, None] * torch.ones((1, 6), dtype=like.dtype, device=like.device)


def _assemble_rhs_diag(M: int, graph: PoseGraph, B: torch.Tensor, g: torch.Tensor):
    """Scatter-add the gradient (M, 6) and the block diagonal (M, 6, 6)."""
    ei, ej = graph.edge_i, graph.edge_j
    b = torch.zeros((M, 6), dtype=B.dtype, device=B.device).index_add_(0, ei, g).index_add_(0, ej, -g)
    D = torch.zeros((M, 6, 6), dtype=B.dtype, device=B.device).index_add_(0, ei, B).index_add_(0, ej, B)
    return b, D


def _hx_local(B: torch.Tensor, ei: torch.Tensor, ej: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Edge-local part of the Hessian-vector product (no damping/gauge)."""
    y = torch.einsum("eab,eb->ea", B, x[ei] - x[ej])  # (E, 6)
    return torch.zeros_like(x).index_add_(0, ei, y).index_add_(0, ej, -y)


def _pcg(matvec, b: torch.Tensor, Minv: torch.Tensor, iters: int, tol: float) -> torch.Tensor:
    """Block-preconditioned CG: solve H x = b with M^-1 given as (M, 6, 6).

    The reference's while loop (k < iters and |r|^2 > tol |b|^2) without a
    host round trip: all `iters` steps are issued, and once the test fails a
    device-side flag sets the step length to 0. x and r then stay as they
    were (x + 0 p = x for finite p), z = M^-1 r is recomputed from the same r
    to the same bits, and p, which no longer reaches x, grows at most by z
    per step; so x is the loop's."""

    def apply_minv(r):
        return torch.einsum("mab,mb->ma", Minv, r)

    x = torch.zeros_like(b)
    r = b
    z = apply_minv(r)
    p = z
    stop = tol * torch.clamp(torch.sum(b * b), min=1e-30)
    active = torch.sum(r * r) > stop
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for _ in range(iters):
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
    return x


def _solve_dense(M: int, graph: PoseGraph, B: torch.Tensor, g: torch.Tensor, damping: float) -> torch.Tensor:
    """Reference dense solve (small graphs / cross-checking)."""
    b, _ = _assemble_rhs_diag(M, graph, B, g)
    ei, ej = graph.edge_i, graph.edge_j
    H = torch.zeros((M, M, 6, 6), dtype=B.dtype, device=B.device)
    H.index_put_((ei, ei), B, accumulate=True)
    H.index_put_((ej, ej), B, accumulate=True)
    H.index_put_((ei, ej), -B, accumulate=True)
    H.index_put_((ej, ei), -B, accumulate=True)
    Hd = H.permute(0, 2, 1, 3).reshape(M * 6, M * 6)
    mask = (torch.arange(M * 6, device=B.device) >= 6).to(B.dtype)
    Hd = Hd * mask[:, None] * mask[None, :]
    Hd = Hd + torch.diag(torch.where(mask > 0, torch.full_like(mask, damping), torch.ones_like(mask)))
    return torch.linalg.solve_ex(Hd, b.reshape(M * 6) * mask).result.reshape(M, 6)


def _solve_pcg(M: int, graph: PoseGraph, B: torch.Tensor, g: torch.Tensor, cfg: PoseGraphConfig) -> torch.Tensor:
    b, D = _assemble_rhs_diag(M, graph, B, g)
    gm = _gauge_mask(M, B)
    b = b * gm
    # Block-Jacobi preconditioner; the gauge row gets the identity (its
    # residual is identically zero, so CG never moves it).
    eye6 = _eye(6, B)
    D = torch.cat([eye6[None], (D + cfg.damping * eye6)[1:]])
    Minv = torch.linalg.inv_ex(D).inverse  # inv_ex: no host check of the factorisation

    hx_edges = lambda x: _hx_local(B, graph.edge_i, graph.edge_j, x)

    def matvec(x):
        x = x * gm
        return hx_edges(x) * gm + cfg.damping * x

    return _pcg(matvec, b, Minv, cfg.cg_iters, cfg.cg_tol)


def _gn_step(graph: PoseGraph, poses: torch.Tensor, cur_cost: torch.Tensor, cfg: PoseGraphConfig):
    """One Gauss-Newton step from (poses, cur_cost): the step is kept only
    if it lowers the cost (decided on the device). Returns the new pair."""
    M = poses.shape[0]
    B, g = _edge_blocks(poses, graph)
    if cfg.solver == "dense":
        dx = _solve_dense(M, graph, B, g, cfg.damping)
    else:
        dx = _solve_pcg(M, graph, B, g, cfg)
    # b accumulated -grad blocks (b_i = +J_j^T W r = -grad_i), so dx is
    # already the descent step.
    new_poses = se3.se3_exp(dx) @ poses
    new_cost = cost(graph._replace(poses=new_poses))
    ok = (new_cost < cur_cost) & torch.isfinite(new_cost)
    return torch.where(ok, new_poses, poses), torch.where(ok, new_cost, cur_cost)


def optimize(graph: PoseGraph, cfg: PoseGraphConfig = PoseGraphConfig()) -> PoseGraphResult:
    """Gauss-Newton with the first node held fixed (gauge), op by op on the
    graph's device: cfg.iters steps, each kept only if it lowers the cost."""
    if cfg.solver not in ("pcg", "dense"):
        raise ValueError(f"unknown pose-graph solver: {cfg.solver}")
    initial = cost(graph)
    poses, cur_cost = graph.poses, initial
    for _ in range(cfg.iters):
        poses, cur_cost = _gn_step(graph, poses, cur_cost, cfg)
    return PoseGraphResult(poses=poses, initial_cost=initial, final_cost=cur_cost)


def sequential_edges(poses: torch.Tensor, weight: float = 1.0) -> PoseGraph:
    """Chain graph over (M, 4, 4) poses: edges i -> i+1 measuring the current
    relative poses (zero residual by construction)."""
    M = poses.shape[0]
    i = torch.arange(M - 1, device=poses.device)
    return PoseGraph(
        poses=poses,
        edge_i=i,
        edge_j=i + 1,
        edge_meas=se3.inverse(poses[:-1]) @ poses[1:],
        edge_weight=torch.full((M - 1,), weight, dtype=poses.dtype, device=poses.device),
    )


def add_edges(graph: PoseGraph, i, j, meas: torch.Tensor, weight) -> PoseGraph:
    """Append (loop-closure) edges. `weight` may be scalar-per-edge (E,),
    diagonal (E, 6) or full (E, 6, 6); mixed forms are promoted to the more
    general one."""
    dev = graph.poses.device
    w_old = graph.edge_weight
    w_new = torch.as_tensor(weight, dtype=w_old.dtype, device=dev)
    if w_new.dim() == 0:
        w_new = w_new[None]
    rank = max(w_old.dim(), w_new.dim())
    if rank == 2:
        if w_old.dim() == 1:
            w_old = w_old[:, None] * torch.ones((1, 6), dtype=w_old.dtype, device=dev)
        if w_new.dim() == 1:
            w_new = w_new[:, None] * torch.ones((1, 6), dtype=w_new.dtype, device=dev)
    elif rank == 3:
        w_old = weight_matrices(w_old, w_old.dtype)
        w_new = weight_matrices(w_new, w_new.dtype)
    return PoseGraph(
        poses=graph.poses,
        edge_i=torch.cat([graph.edge_i, torch.as_tensor(i, dtype=torch.int64, device=dev)]),
        edge_j=torch.cat([graph.edge_j, torch.as_tensor(j, dtype=torch.int64, device=dev)]),
        edge_meas=torch.cat([graph.edge_meas, meas.to(graph.edge_meas.dtype)]),
        edge_weight=torch.cat([w_old, w_new]),
    )


def next_bucket(n: int, floor: int = 16) -> int:
    """Smallest power of two >= max(n, floor): the reference's shape bucket
    for (M, E)."""
    b = floor
    while b < n:
        b *= 2
    return b


def pad_graph(graph: PoseGraph, m_bucket: int, e_bucket: int) -> PoseGraph:
    """Pad to (m_bucket nodes, e_bucket edges) with inert filler: identity
    padding nodes with no edges (zero gradient, so preconditioned CG never
    moves them) and zero-weight self-loops on node 0. Slice
    `result.poses[:M]` to recover the real nodes."""
    M = graph.poses.shape[0]
    E = graph.edge_i.shape[0]
    if m_bucket < M or e_bucket < E:
        raise ValueError(f"bucket smaller than graph: {(m_bucket, e_bucket)} < {(M, E)}")
    if m_bucket == M and e_bucket == E:
        return graph
    eye4 = _eye(4, graph.poses)
    pe = e_bucket - E
    w = graph.edge_weight
    zeros = torch.zeros(pe, dtype=graph.edge_i.dtype, device=graph.edge_i.device)
    return PoseGraph(
        poses=torch.cat([graph.poses, eye4.expand(m_bucket - M, 4, 4)]),
        edge_i=torch.cat([graph.edge_i, zeros]),
        edge_j=torch.cat([graph.edge_j, zeros]),
        edge_meas=torch.cat([graph.edge_meas, eye4.expand(pe, 4, 4)]),
        edge_weight=torch.cat([w, torch.zeros((pe,) + tuple(w.shape[1:]), dtype=w.dtype, device=w.device)]),
    )


def scale_free_weight(meas: torch.Tensor, w_rot: float, w_dir: float) -> torch.Tensor:
    """(E, 6, 6) information for monocular scale-free loop edges: full
    rotation information, and translation information only orthogonal to the
    measured direction (in the measurement's target frame), so no |t| is
    imposed."""
    t = (se3.rotation(meas).transpose(-1, -2) @ se3.translation(meas)[..., None])[..., 0]
    u = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    I3 = _eye(3, meas)
    W = torch.zeros(meas.shape[:-2] + (6, 6), dtype=meas.dtype, device=meas.device)
    W[..., :3, :3] = w_dir * (I3 - u[..., :, None] * u[..., None, :])
    W[..., 3:, 3:] = w_rot * I3
    return W
