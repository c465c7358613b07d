"""SO(3) utilities: exp/log maps and the two-vector rotation
(rebvio_tpu/geometry/so3.py).  float32, batched over leading dims, guarded
around theta ~ 0 and theta ~ pi exactly like the JAX version."""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]_x such that hat(w) @ v == cross(w, v)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: exp([w]_x) with Taylor fallbacks near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-8
    one = torch.ones_like(theta)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / torch.where(small, one, theta))
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, theta2))
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues: rotation vector from a rotation matrix."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(torch.clamp(cos_t, -1.0 + 3e-7, 1.0 - 3e-7))
    v = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    small = cos_t > 1.0 - 1e-7
    scale_generic = theta / (2.0 * torch.sin(theta))
    scale_small = 0.5 + (3.0 - trace) / 12.0
    w_generic = torch.where(small[..., None], scale_small[..., None] * v,
                            scale_generic[..., None] * v)

    near_pi = theta > (math.pi - 1e-3)
    d = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp((d + 1.0) * 0.5, min=0.0))
    k = torch.argmax(axis_abs, dim=-1)
    off = torch.stack([
        R[..., 1, 0] + R[..., 0, 1],
        R[..., 2, 0] + R[..., 0, 2],
        R[..., 2, 1] + R[..., 1, 2],
    ], dim=-1)

    def sgn(o):
        return torch.sign(o) + (o == 0).to(o.dtype)

    one = torch.ones_like(off[..., 0])
    s0 = torch.where(k == 0, one, torch.where(k == 1, sgn(off[..., 0]), sgn(off[..., 1])))
    s1 = torch.where(k == 1, one, torch.where(k == 0, sgn(off[..., 0]), sgn(off[..., 2])))
    s2 = torch.where(k == 2, one, torch.where(k == 0, sgn(off[..., 1]), sgn(off[..., 2])))
    axis_pi = torch.stack([s0 * axis_abs[..., 0], s1 * axis_abs[..., 1],
                           s2 * axis_abs[..., 2]], dim=-1)
    nrm = torch.linalg.norm(axis_pi, dim=-1, keepdim=True)
    axis_pi = axis_pi / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    vn = torch.sqrt(torch.sum(v * v, dim=-1) + 1e-24)
    theta_pi = math.pi - torch.arcsin(torch.clamp(0.5 * vn, 0.0, 1.0 - 1e-7))
    w_pi = axis_pi * theta_pi[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _normalize(a: torch.Tensor) -> torch.Tensor:
    return a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True), min=_EPS)


def rotation_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation matrix taking direction a to direction b (minimal geodesic)."""
    a = _normalize(a)
    b = _normalize(b)
    v = torch.linalg.cross(a, b)
    c = torch.sum(a * b, dim=-1)
    s2 = torch.sum(v * v, dim=-1)
    V = hat(v)
    k = (1.0 - c) / torch.where(s2 < _EPS, torch.ones_like(s2), s2)
    R_gen = _eye_like(V) + V + k[..., None, None] * (V @ V)
    # the axes as rows of an identity made on a's device: a scalar assigned
    # into a device tensor would be a host-to-device copy, a host sync
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    alt = torch.where((torch.abs(a[..., 0]) < 0.9)[..., None], eye[0], eye[1])
    ortho = _normalize(torch.linalg.cross(a, alt))
    R_pi = exp(ortho * math.pi)
    antipodal = c < -1.0 + 1e-6
    return torch.where(antipodal[..., None, None], R_pi, R_gen)
