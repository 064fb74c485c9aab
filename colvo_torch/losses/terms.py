"""Regularizer and consistency loss terms (port of ``colvo/losses/terms.py``)."""

from __future__ import annotations

from typing import Tuple

import torch


class LocalReductions:
    """The loss's batch-level reductions in one process: ``torch.sum`` and
    ``torch.mean``. ``runtime.mesh.Mesh`` has the same two methods, global
    over the data-parallel ranks."""

    @staticmethod
    def sum(x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x)

    @staticmethod
    def mean(x: torch.Tensor) -> torch.Tensor:
        return torch.mean(x)


LOCAL = LocalReductions()


def smoothness_loss(disp: torch.Tensor, img: torch.Tensor, mesh=LOCAL) -> torch.Tensor:
    """Edge-aware, mean-normalized disparity smoothness
    ``Σ |∂d̂|·exp(−|∂I|)``, d̂ = d / mean(d). disp (B, H, W, 1), img (B, H, W, 3).
    The batch means are ``mesh``'s (d̂'s mean is per image)."""
    mean_disp = torch.mean(disp, dim=(1, 2), keepdim=True)
    norm_disp = disp / (mean_disp + 1e-7)

    grad_x = torch.abs(norm_disp[:, :, 1:] - norm_disp[:, :, :-1])
    grad_y = torch.abs(norm_disp[:, 1:, :] - norm_disp[:, :-1, :])

    img_gx = torch.mean(torch.abs(img[:, :, 1:] - img[:, :, :-1]), dim=-1, keepdim=True)
    img_gy = torch.mean(torch.abs(img[:, 1:, :] - img[:, :-1, :]), dim=-1, keepdim=True)

    grad_x = grad_x * torch.exp(-img_gx)
    grad_y = grad_y * torch.exp(-img_gy)
    return mesh.mean(grad_x) + mesh.mean(grad_y)


def geometry_consistency(
    computed_depth: torch.Tensor,
    sampled_depth: torch.Tensor,
    valid: torch.Tensor,
    behind: torch.Tensor | None = None,
    mesh=LOCAL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DCDP cross-frame depth-consistency residual
    ``|D_c − D_s| / (D_c + D_s)`` on valid pixels → (loss, weight = 1 − diff).

    ``behind`` (z ≤ 0) pixels score 1 + |z|/s, gated on a per-image behind
    fraction above 5 % (else a constant 1), and always count toward the
    mean; see the JAX function for why. The masked mean's sums are
    ``mesh``'s (the behind fraction is per image).
    """
    raw = computed_depth
    if behind is not None:
        # keep the diff branch finite where z≤0 (where-grad trap)
        computed_depth = torch.where(behind, sampled_depth, computed_depth)
    diff = torch.abs(computed_depth - sampled_depth) / (
        computed_depth + sampled_depth + 1e-7
    )
    diff = torch.clamp(diff, 0.0, 1.0)
    if behind is not None:
        pen = torch.clamp(1.0 - raw / (torch.abs(sampled_depth) + 1e-7), max=10.0)
        bfrac = torch.mean(
            behind.to(diff.dtype), dim=tuple(range(1, behind.ndim)), keepdim=True
        )
        pen = torch.where(bfrac > 0.05, pen, torch.ones_like(pen))
        diff = torch.where(behind, pen, diff)
        valid = torch.maximum(valid, behind.to(diff.dtype))
    diff = diff * valid
    loss = mesh.sum(diff) / (mesh.sum(valid) + 1e-7)
    weight = torch.clamp(1.0 - diff, 0.0, 1.0) * valid
    return loss, weight


def min_reprojection(errors: torch.Tensor) -> torch.Tensor:
    """Per-pixel min over source-frame errors: (B, H, W, S) → (B, H, W).
    ``amin`` splits the gradient evenly across ties, as JAX's min does."""
    return torch.amin(errors, dim=-1)


def automask(
    warped_errors: torch.Tensor, identity_errors: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stationary-pixel automasking with a 1e-5 tie bias on the identity
    errors. Both (B, H, W, S) → (min warped error, float keep-mask)."""
    min_warped = torch.amin(warped_errors, dim=-1)
    min_identity = torch.amin(identity_errors, dim=-1) + 1e-5
    mask = (min_warped < min_identity).to(min_warped.dtype)
    return min_warped, mask
