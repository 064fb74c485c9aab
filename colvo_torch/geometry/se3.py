"""SE(3) operations (port of ``colvo/geometry/se3.py``).

Axis-angle → rotation (Rodrigues / exp map), full SE(3) exp/log, 4×4
inverse, batched over leading dims. Stable near θ→0 through Taylor
expansions behind a double ``where``: the pose head starts near θ=0, where
a naive ``sqrt`` of θ² would give NaN gradients.
"""

from __future__ import annotations

import torch

# Below this θ² the closed forms are replaced by their Taylor expansions.
_EPS2 = 1e-8


def _sinc_terms(theta_sq: torch.Tensor):
    """Return (A, B, C) = (sinθ/θ, (1−cosθ)/θ², (θ−sinθ)/θ³), stable at 0.

    The untaken closed-form branch sees θ²=1 instead of ~0, so it never
    divides by ~0 and its gradient stays finite.
    """
    small = theta_sq < _EPS2
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / safe_sq)
    c = torch.where(
        small, 1.0 / 6.0 - theta_sq / 120.0, (theta - torch.sin(theta)) / (safe_sq * theta)
    )
    return a, b, c


def _hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of (..., 3) vectors → (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(k: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=k.dtype, device=k.device).expand(k.shape)


def axis_angle_to_matrix(axisangle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle → (..., 3, 3), R = I + A·[w]ₓ + B·[w]ₓ²."""
    theta_sq = torch.sum(axisangle * axisangle, dim=-1, keepdim=True)[..., None]
    a, b, _ = _sinc_terms(theta_sq)
    k = _hat(axisangle)
    return _eye_like(k) + a * k + b * (k @ k)


def matrix_to_axis_angle(rot: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation → (..., 3) axis-angle (log map). Stable near 0."""
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)[..., None]
    w = torch.stack(
        [
            rot[..., 2, 1] - rot[..., 1, 2],
            rot[..., 0, 2] - rot[..., 2, 0],
            rot[..., 1, 0] - rot[..., 0, 1],
        ],
        dim=-1,
    )
    # w = 2 sinθ · axis;   axisangle = θ · axis
    scale = torch.where(
        theta < 1e-4, 0.5 + theta**2 / 12.0, theta / (2.0 * torch.sin(theta))
    )
    return w * scale


def _rt_to_mat(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation + (..., 3) translation → (..., 4, 4)."""
    top = torch.cat([rot, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype, device=rot.device)
    bottom = bottom.expand(rot.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: (..., 6) twist [w | v] → (..., 4, 4); t = V·v."""
    w, v = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    a, b, c = _sinc_terms(theta_sq)
    k = _hat(w)
    k2 = k @ k
    eye = _eye_like(k)
    rot = eye + a * k + b * k2
    vmat = eye + b * k + c * k2
    t = torch.einsum("...ij,...j->...i", vmat, v)
    return _rt_to_mat(rot, t)


def se3_log(mat: torch.Tensor) -> torch.Tensor:
    """SE(3) log map: (..., 4, 4) → (..., 6) twist [w | v]."""
    rot = mat[..., :3, :3]
    t = mat[..., :3, 3]
    w = matrix_to_axis_angle(rot)
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    a, b, _ = _sinc_terms(theta_sq)
    k = _hat(w)
    # V⁻¹ = I − ½[w]ₓ + (1/θ²)(1 − A/(2B))·[w]ₓ²
    coef = torch.where(
        theta_sq < _EPS2,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - a / (2.0 * b)) / torch.clamp(theta_sq, min=_EPS2),
    )
    vinv = _eye_like(k) - 0.5 * k + coef * (k @ k)
    v = torch.einsum("...ij,...j->...i", vinv, t)
    return torch.cat([w, v], dim=-1)


def transformation_from_parameters(
    axisangle: torch.Tensor, translation: torch.Tensor, invert: bool = False
) -> torch.Tensor:
    """PoseNet output → 4×4 transform ``[R(aa) | t]``; ``invert=True``
    returns ``[Rᵀ | −Rᵀ t]`` (Monodepth2 semantics)."""
    rot = axis_angle_to_matrix(axisangle)
    if invert:
        rot = rot.transpose(-1, -2)
        translation = -torch.einsum("...ij,...j->...i", rot, translation)
    return _rt_to_mat(rot, translation)


def invert_transform(mat: torch.Tensor) -> torch.Tensor:
    """Invert (..., 4, 4) rigid transforms analytically: [Rᵀ | −Rᵀt]."""
    rot = mat[..., :3, :3].transpose(-1, -2)
    t = -torch.einsum("...ij,...j->...i", rot, mat[..., :3, 3])
    return _rt_to_mat(rot, t)


def renormalize_rotation(mat: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) via Gram–Schmidt."""
    r = mat[..., :3, :3]
    x = r[..., :, 0]
    y = r[..., :, 1]
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    y = y - torch.sum(x * y, dim=-1, keepdim=True) * x
    y = y / torch.linalg.norm(y, dim=-1, keepdim=True)
    z = torch.linalg.cross(x, y, dim=-1)
    rot = torch.stack([x, y, z], dim=-1)
    return _rt_to_mat(rot, mat[..., :3, 3])
