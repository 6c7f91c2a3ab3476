"""SO(3)/SE(3) math on torch tensors — port of droplet_visual_odometry_tpu/core/se3.py.

Every function broadcasts over leading batch dimensions, as in the reference.

Conventions (unchanged): quaternions are xyzw; SE(3) poses are (..., 4, 4).
"""

from __future__ import annotations

import torch

from plainref.utils.device import constant


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> xyzw quaternion (..., 4), w >= 0.

    Branch-free Shepperd method: all four candidates, pick the largest
    denominator (reference: core/se3.py:rotmat_to_quat)."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    m01, m02, m10 = R[..., 0, 1], R[..., 0, 2], R[..., 1, 0]
    m12, m20, m21 = R[..., 1, 2], R[..., 2, 0], R[..., 2, 1]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-12))

    cw = torch.stack([m21 - m12, m02 - m20, m10 - m01, qw2], -1) / safe_sqrt(qw2)[..., None]
    cx = torch.stack([qx2, m01 + m10, m02 + m20, m21 - m12], -1) / safe_sqrt(qx2)[..., None]
    cy = torch.stack([m01 + m10, qy2, m12 + m21, m02 - m20], -1) / safe_sqrt(qy2)[..., None]
    cz = torch.stack([m02 + m20, m12 + m21, qz2, m10 - m01], -1) / safe_sqrt(qz2)[..., None]
    cands = torch.stack([cw, cx, cy, cz], dim=-2)  # (..., 4, 4)
    idx = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], -1), dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 3:4] < 0, -q, q)


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = constant((0.0, 0.0, 0.0, 1.0), top.dtype, top.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Exact SE(3) inverse: [R t]^-1 = [R^T  -R^T t]."""
    Rt = rotation(T).transpose(-1, -2)
    return make_se3(Rt, -(Rt @ translation(T)[..., None])[..., 0])


def velocity_between_timestamps(
    prev_T: torch.Tensor, curr_T: torch.Tensor, prev_t: torch.Tensor, curr_t: torch.Tensor
) -> torch.Tensor:
    """Finite-difference 'velocity' 4x4 with the reference's element-wise
    rotation rate (reference: core/se3.py:velocity_between_timestamps)."""
    dt = torch.clamp(curr_t - prev_t, min=1e-9)
    dT = (translation(curr_T) - translation(prev_T)) / dt[..., None]
    dR = (rotation(curr_T) - rotation(prev_T)) / dt[..., None, None]
    return make_se3(dR, dT)


def _hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    m = torch.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _sinc(x: torch.Tensor) -> torch.Tensor:
    small = torch.abs(x) < 1e-3
    x_safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(x_safe) / x_safe)


def _exp_coeff_B(theta: torch.Tensor) -> torch.Tensor:
    """(1-cos t)/t^2 = 0.5*sinc(t/2)^2, cancellation-free in f32."""
    s = _sinc(0.5 * theta)
    return 0.5 * s * s


def _exp_coeff_C(theta: torch.Tensor) -> torch.Tensor:
    """(1 - sinc t)/t^2: series below 1 rad, exact trig beyond."""
    t2 = theta * theta
    series = 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0
    theta_safe = torch.where(theta < 1.0, torch.ones_like(theta), theta)
    exact = (1.0 - torch.sin(theta_safe) / theta_safe) / (theta_safe * theta_safe)
    return torch.where(theta < 1.0, series, exact)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) -> axis-angle (..., 3) by the quaternion route."""
    q = rotmat_to_quat(R)
    qv = q[..., :3]
    qw = torch.clamp(q[..., 3], min=1e-12)
    qn2 = torch.sum(qv * qv, dim=-1)
    small = qn2 < 1e-10
    qn_safe = torch.sqrt(torch.where(small, torch.ones_like(qn2), qn2))
    factor = torch.where(
        small,
        2.0 / qw * (1.0 - qn2 / (3.0 * qw * qw)),
        2.0 * torch.atan2(qn_safe, qw) / qn_safe,
    )
    return qv * factor[..., None]


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) [v, w] -> 4x4."""
    v, w = xi[..., :3], xi[..., 3:]
    theta = torch.sqrt(torch.clamp(torch.sum(w * w, dim=-1), min=1e-24))
    A = _sinc(theta)
    B = _exp_coeff_B(theta)
    C = _exp_coeff_C(theta)
    W = _hat(w)
    I = _eye_like(W)
    WW = W @ W
    R = I + A[..., None, None] * W + B[..., None, None] * WW
    V = I + B[..., None, None] * W + C[..., None, None] * WW
    return make_se3(R, (V @ v[..., None])[..., 0])


def _log_coeff(theta: torch.Tensor) -> torch.Tensor:
    """(1 - (t/2) cot(t/2)) / t^2, the coefficient of W^2 in V^-1: series
    below 1 rad, half-angle exact form beyond."""
    t2 = theta * theta
    series = 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0
    theta_safe = torch.where(theta < 1.0, torch.full_like(theta, 2.0), theta)
    half = 0.5 * theta_safe
    exact = (1.0 - half * torch.cos(half) / torch.sin(half)) / (theta_safe * theta_safe)
    return torch.where(theta < 1.0, series, exact)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """4x4 -> twist (..., 6) [v, w]; inverse of se3_exp, with
    V^-1 = I - W/2 + coef(theta) W^2."""
    w = so3_log(rotation(T))
    theta = torch.sqrt(torch.clamp(torch.sum(w * w, dim=-1), min=1e-24))
    W = _hat(w)
    Vinv = _eye_like(W) - 0.5 * W + _log_coeff(theta)[..., None, None] * (W @ W)
    v = (Vinv @ translation(T)[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint (..., 6, 6) for [v, w] twists: [[R, hat(t) R], [0, R]],
    so that T exp(xi) T^-1 = exp(Adj(T) xi)."""
    R = rotation(T)
    top = torch.cat([R, _hat(translation(T)) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def ad(xi: torch.Tensor) -> torch.Tensor:
    """se(3) small adjoint (..., 6, 6) for [v, w] twists: [[hat(w), hat(v)], [0, hat(w)]]."""
    vx = _hat(xi[..., :3])
    wx = _hat(xi[..., 3:])
    top = torch.cat([wx, vx], dim=-1)
    bot = torch.cat([torch.zeros_like(wx), wx], dim=-1)
    return torch.cat([top, bot], dim=-2)


def compose(*Ts: torch.Tensor) -> torch.Tensor:
    """Chain 4x4 transforms left to right: compose(A, B, C) = A @ B @ C."""
    out = Ts[0]
    for T in Ts[1:]:
        out = out @ T
    return out

