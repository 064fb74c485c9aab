"""Train step (port of ``colvo/runtime/train_step.py``).

Coupled DCDP forward over the snippet batch → total loss → backward →
global-norm clip → Adam with the family step-decay schedule (optional
linear warmup) and the geo-weight ramp. Parameters are float32; convs
compute in ``model.dtype``. The step updates the model and optimizer in
place (PyTorch style) and returns device tensors without synchronising.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

import numpy as np
import torch

from colvo_torch import resolve_device
from colvo_torch.config import ColvoConfig
from colvo_torch.losses import snippet_loss
from colvo_torch.models import ColVOModel


@dataclass
class TrainState:
    model: ColVOModel
    optimizer: torch.optim.Optimizer
    step: int
    steps_per_epoch: int


def learning_rate(cfg: ColvoConfig, step: int, steps_per_epoch: int = 1000) -> float:
    """optax ``piecewise_constant_schedule`` (×decay from the decay step
    on), behind ``linear_schedule`` warmup via ``join_schedules``."""
    t = cfg.train
    if t.warmup_steps > 0:
        if step < t.warmup_steps:
            return t.lr * step / t.warmup_steps
        step -= t.warmup_steps
    decay_step = t.lr_decay_epochs * steps_per_epoch
    return t.lr * (t.lr_decay_factor if step >= decay_step else 1.0)


def geo_scale(cfg: ColvoConfig, step: int) -> float:
    """Linear ramp of the geo weight over ``loss.geo_ramp_steps``."""
    if cfg.loss.geo_ramp_steps > 0:
        return min(1.0, (step + 1.0) / cfg.loss.geo_ramp_steps)
    return 1.0


def init_state(
    cfg: ColvoConfig,
    seed: int | None = None,
    device: str | torch.device = "cuda",
    steps_per_epoch: int = 1000,
) -> TrainState:
    """Build the model (Flax-like init from ``seed``, default
    ``train.seed``) and its Adam optimizer on ``device``."""
    device = resolve_device(device)
    if cfg.train.adam_mu_dtype not in ("", "float32"):
        raise NotImplementedError(f"train.adam_mu_dtype={cfg.train.adam_mu_dtype!r} is not ported yet")
    if cfg.train.deterministic and device.type == "cuda":
        raise NotImplementedError(
            "train.deterministic=True on CUDA: the bilinear_scatter kernel adds "
            "with float atomics, whose order changes from run to run"
        )
    gen = torch.Generator().manual_seed(cfg.train.seed if seed is None else seed)
    model = ColVOModel(cfg.model)
    model.reset_parameters(gen)
    model.to(device)
    params = list(model.parameters())
    if cfg.train.weight_decay > 0:
        opt = torch.optim.AdamW(params, lr=cfg.train.lr, weight_decay=cfg.train.weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=cfg.train.lr)
    return TrainState(model, opt, 0, steps_per_epoch)


def to_device(batch: Mapping[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch (numpy) → float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32).to(device)
            for k, v in batch.items()}


def loss_fn(model: ColVOModel, batch: Mapping[str, torch.Tensor], cfg: ColvoConfig,
            geo_scale: float = 1.0):
    """Forward + ``snippet_loss`` → (loss, aux without the depth map)."""
    disps, poses = model(batch["frames"])
    k = batch["k"]
    loss, aux = snippet_loss(
        disps, poses, batch["frames"], k, torch.linalg.inv(k), cfg.loss, cfg.model,
        frames_clean=batch.get("frames_clean"), geo_scale=geo_scale,
    )
    aux.pop("depth/full", None)
    return loss, aux


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``: scale by max_norm/‖g‖ only when
    ‖g‖ ≥ max_norm (no +1e-6 in the divisor). Returns ‖g‖ before clipping."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
               cfg: ColvoConfig) -> Dict[str, torch.Tensor]:
    """One optimisation step on ``batch`` ({frames, frames_clean, k} on the
    state's device); updates ``state`` in place and returns the metrics
    (aux terms and ``grad_norm``) as device scalars."""
    model, opt = state.model, state.optimizer
    model.train()
    opt.zero_grad(set_to_none=True)
    loss, aux = loss_fn(model, batch, cfg, geo_scale(cfg, state.step))
    loss.backward()
    params = [p for p in model.parameters() if p.grad is not None]
    grad_norm = clip_by_global_norm([p.grad for p in params], cfg.train.grad_clip)
    lr = learning_rate(cfg, state.step, state.steps_per_epoch)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    state.step += 1
    metrics = {k: v.detach() for k, v in aux.items()}
    metrics["grad_norm"] = grad_norm
    return metrics
