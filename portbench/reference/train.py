"""The first training steps, plain: forward, loss, backward, global-norm
clip, Adam in optax's order of operations.

``steps`` starts from the weights the benchmark made and runs one step a
batch; it returns each step's loss terms, the first step's gradient as
the optimizer receives it (after the clip) and each leaf's change after
the last step. ``half=True`` is the fault that leaves out the second half
of every batch and takes the means over the rest.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.reference import precise
from portbench.reference.loss import snippet_loss
from portbench.reference.model import Quant, snippet_forward

B1, B2, EPS = 0.9, 0.999, 1e-8


def learning_rate(train_cfg, step: int, steps_per_epoch: int) -> float:
    if train_cfg.warmup_steps > 0:
        if step < train_cfg.warmup_steps:
            return train_cfg.lr * step / train_cfg.warmup_steps
        step -= train_cfg.warmup_steps
    decay = step >= train_cfg.lr_decay_epochs * steps_per_epoch
    return train_cfg.lr * (train_cfg.lr_decay_factor if decay else 1.0)


def steps(weights: Dict[str, torch.Tensor], batches: List[dict], cfg, steps_per_epoch: int,
          quant: Quant = None, half: bool = False) -> dict:
    """One step a batch of ``batches`` ({frames, frames_clean, k}) from
    ``weights``. Returns {"losses": [{term: float}], "grad": {name: the
    first step's clipped gradient}, "delta": {name: weight − start}}."""
    if cfg.train.weight_decay or cfg.train.adam_mu_dtype not in ("", "float32"):
        raise NotImplementedError("the reference's Adam has no weight decay and an f32 moment")
    if cfg.loss.geo_ramp_steps:
        raise NotImplementedError("the reference has no geo ramp")
    names = list(weights)
    with precise():
        params = {n: weights[n].detach().clone().float().requires_grad_(True) for n in names}
        mu = {n: torch.zeros_like(p) for n, p in params.items()}
        nu = {n: torch.zeros_like(p) for n, p in params.items()}
        losses, first_grad = [], None
        for t, batch in enumerate(batches, start=1):
            frames, clean, k = batch["frames"], batch["frames_clean"], batch["k"]
            if half:
                frames, clean = frames[: len(frames) // 2], clean[: len(clean) // 2]
            disps, poses = snippet_forward(params, frames, cfg.model, quant)
            terms = snippet_loss(disps, poses, clean, k, cfg.loss, cfg.model)
            grads = torch.autograd.grad(terms["loss/total"], [params[n] for n in names],
                                        allow_unused=True)
            grads = [torch.zeros_like(params[n]) if g is None else g
                     for n, g in zip(names, grads)]
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                         for g in grads]))
            if norm >= cfg.train.grad_clip:
                grads = [g * (cfg.train.grad_clip / norm) for g in grads]
            if first_grad is None:
                first_grad = {n: g.detach().clone() for n, g in zip(names, grads)}
            lr = learning_rate(cfg.train, t - 1, steps_per_epoch)
            bc1, bc2 = 1.0 - B1 ** t, 1.0 - B2 ** t
            with torch.no_grad():
                for n, g in zip(names, grads):
                    mu[n] = (1.0 - B1) * g + B1 * mu[n]
                    nu[n] = (1.0 - B2) * g * g + B2 * nu[n]
                    upd = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + EPS)
                    params[n] -= lr * upd
            losses.append({key: float(v.detach()) for key, v in terms.items()})
        delta = {n: (params[n].detach() - weights[n].float()) for n in names}
    return {"losses": losses, "grad": first_grad, "delta": delta}


def leaf_gap(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
             keep: Optional[List[str]] = None, median: bool = False) -> tuple:
    """The worst leaf's gap of norms: max over leaves of |‖a‖ − ‖b‖| over
    the larger of ‖b‖ and the median leaf's ‖b‖ (``median``: the median
    leaf's gap). Returns (gap, leaf)."""
    names = keep if keep is not None else list(reference)
    ref = {n: float(torch.linalg.vector_norm(reference[n].double())) for n in names}
    med = float(torch.tensor(sorted(ref.values())).median())
    each = {n: abs(float(torch.linalg.vector_norm(program[n].double())) - ref[n])
            / max(ref[n], med, 1e-30) for n in names}
    if median:
        return float(torch.tensor(sorted(each.values())).median()), ""
    leaf = max(each, key=each.get)
    return each[leaf], leaf


def moving_leaves(grad: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose first gradient is at least a thousandth of the median
    leaf's norm (the others move under Adam by round-off alone)."""
    norms = {n: float(torch.linalg.vector_norm(g.double())) for n, g in grad.items()}
    med = float(torch.tensor(sorted(norms.values())).median())
    return [n for n, v in norms.items() if v >= 1e-3 * med]
