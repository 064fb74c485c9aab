"""Train step (port of ``colvo/runtime/train_step.py``).

Coupled DCDP forward over the snippet batch → total loss → backward →
global-norm clip → Adam with the family step-decay schedule (optional
linear warmup) and the geo-weight ramp. Parameters are float32; convs
compute in ``model.dtype``. The step updates the model and optimizer in
place (PyTorch style) and returns device tensors without synchronising.

``make_train_step`` is the step as one program: on CUDA a CUDA graph,
captured once a batch shape and replayed once a call (``runtime.graphs``).
``make_scan_train`` folds K such steps over a device-resident corpus into
one chunk, one CUDA graph replayed once a call. On CUDA, Adam
(``optim.Adam``) is capturable and reads its learning rate from a device
tensor, so no step reads a host scalar. ``train_step`` is the eager step,
the body both capture.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from colvo_torch import resolve_device
from colvo_torch.config import ColvoConfig
from colvo_torch.data.device_store import assemble
from colvo_torch.kernels import clip_global_norm
from colvo_torch.losses import snippet_loss
from colvo_torch.models import ColVOModel
from colvo_torch.runtime.graphs import Graphed
from colvo_torch.runtime.mesh import Mesh
from colvo_torch.runtime.optim import Adam


@dataclass
class TrainState:
    """The model, its optimizer and the step count; under data parallel
    also the ``mesh`` the batch is split over (None: one process)."""

    model: ColVOModel
    optimizer: torch.optim.Optimizer
    step: int
    steps_per_epoch: int
    mesh: Optional[Mesh] = None


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


def learning_rate_t(cfg: ColvoConfig, step: torch.Tensor,
                    steps_per_epoch: int = 1000) -> torch.Tensor:
    """``learning_rate`` of an int64 step tensor, on its device and without
    a host sync: computed in float64 in the host function's order (so the
    two agree exactly), returned as float32."""
    t = cfg.train
    s = step.to(torch.float64)
    after = s - t.warmup_steps if t.warmup_steps > 0 else s
    decay_step = t.lr_decay_epochs * steps_per_epoch
    lr = torch.where(after >= decay_step, torch.full_like(s, t.lr * t.lr_decay_factor), t.lr)
    if t.warmup_steps > 0:
        lr = torch.where(s < t.warmup_steps, t.lr * s / t.warmup_steps, lr)
    return lr.to(torch.float32)


def geo_scale_t(cfg: ColvoConfig, step: torch.Tensor) -> torch.Tensor | float:
    """``geo_scale`` of an int64 step tensor, on its device (float32)."""
    if cfg.loss.geo_ramp_steps > 0:
        ramp = (step.to(torch.float64) + 1.0) / cfg.loss.geo_ramp_steps
        return torch.clamp(ramp, max=1.0).to(torch.float32)
    return 1.0


def init_state(
    cfg: ColvoConfig,
    seed: int | None = None,
    device: str | torch.device = "cuda",
    steps_per_epoch: int = 1000,
) -> TrainState:
    """Build the model (Flax-like init from ``seed``, default
    ``train.seed``) and its optimizer on ``device``: ``optim.Adam`` in
    optax's order of operations (AdamW with ``train.weight_decay``; the
    first moment in bf16 under ``train.adam_mu_dtype="bfloat16"``)."""
    device = resolve_device(device)
    if cfg.train.adam_mu_dtype not in ("", "float32", "bfloat16"):
        raise ValueError(
            "train.adam_mu_dtype must be ''|float32|bfloat16, "
            f"got {cfg.train.adam_mu_dtype!r}"
        )
    gen = torch.Generator().manual_seed(cfg.train.seed if seed is None else seed)
    model = ColVOModel(cfg.model)
    model.reset_parameters(gen)
    model.to(device)
    params = list(model.parameters())
    if device.type == "cuda":
        # the learning rate as a device tensor, which each step overwrites:
        # the update reads no host scalar and can be captured
        kw = {"lr": torch.full((), cfg.train.lr, device=device), "capturable": True}
    else:
        kw = {"lr": cfg.train.lr}
    mu_dtype = torch.bfloat16 if cfg.train.adam_mu_dtype == "bfloat16" else torch.float32
    opt = Adam(params, weight_decay=cfg.train.weight_decay, mu_dtype=mu_dtype, **kw)
    return TrainState(model, opt, 0, steps_per_epoch)


def to_device(batch: Mapping[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host batch (numpy) → float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32).to(device)
            for k, v in batch.items()}


def loss_fn(model: ColVOModel, batch: Mapping[str, torch.Tensor], cfg: ColvoConfig,
            geo_scale: float = 1.0, mesh: Optional[Mesh] = None):
    """Forward + ``snippet_loss`` → (loss, aux without the depth map);
    with ``mesh``, ``batch`` is this rank's rows and the loss the global
    batch's."""
    disps, poses = model(batch["frames"])
    k = batch["k"]
    loss, aux = snippet_loss(
        disps, poses, batch["frames"], k, torch.linalg.inv_ex(k).inverse, cfg.loss, cfg.model,
        frames_clean=batch.get("frames_clean"), geo_scale=geo_scale, mesh=mesh,
    )
    aux.pop("depth/full", None)
    return loss, aux


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``: scale by max_norm/‖g‖ only when
    ‖g‖ ≥ max_norm (no +1e-6 in the divisor), in place. Returns ‖g‖ before
    clipping. ``kernels.clip_global_norm``: kernel A's A/sumsq and A/clip
    on the card, the plain foreach chain on the CPU."""
    return clip_global_norm(grads, max_norm)


def _set_learning_rate(opt: torch.optim.Optimizer, lr: float | torch.Tensor) -> None:
    """Write ``lr`` into every parameter group: in place where the group
    holds a device tensor (capturable Adam), else as a float."""
    for group in opt.param_groups:
        if not isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(lr)
        elif isinstance(lr, torch.Tensor):
            group["lr"].copy_(lr)
        else:
            group["lr"].fill_(lr)


def _update(state: TrainState, batch: Mapping[str, torch.Tensor], cfg: ColvoConfig,
            geo: float | torch.Tensor, lr: float | torch.Tensor,
            set_to_none: bool = True) -> Dict[str, torch.Tensor]:
    """Forward, loss, backward, clip and Adam on ``batch``; the metrics.
    Under data parallel the gradients are summed over the ranks before the
    clip."""
    model, opt = state.model, state.optimizer
    model.train()
    opt.zero_grad(set_to_none=set_to_none)
    loss, aux = loss_fn(model, batch, cfg, geo, state.mesh)
    loss.backward()
    params = [p for p in model.parameters() if p.grad is not None]
    if state.mesh is not None:
        state.mesh.all_reduce_grads([p.grad for p in params])
    grad_norm = clip_by_global_norm([p.grad for p in params], cfg.train.grad_clip)
    _set_learning_rate(opt, lr)
    opt.step()
    metrics = {k: v.detach() for k, v in aux.items()}
    metrics["grad_norm"] = grad_norm
    return metrics


def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
               cfg: ColvoConfig) -> Dict[str, torch.Tensor]:
    """One optimisation step on ``batch`` ({frames, frames_clean, k} on the
    state's device; this rank's rows under data parallel); updates ``state`` in place and returns the metrics
    (aux terms and ``grad_norm``) as device scalars."""
    metrics = _update(state, batch, cfg, geo_scale(cfg, state.step),
                      learning_rate(cfg, state.step, state.steps_per_epoch))
    state.step += 1
    return metrics


def _mutable(state: TrainState, counter: torch.Tensor) -> List[torch.Tensor]:
    """The tensors a step updates in place: the weights, the model's buffers
    (BatchNorm's running statistics), every tensor of the optimizer's state
    and parameter groups, and the device step counter."""
    opt = state.optimizer
    out = list(state.model.parameters()) + list(state.model.buffers())
    out += [v for st in opt.state.values() for v in st.values() if isinstance(v, torch.Tensor)]
    out += [g["lr"] for g in opt.param_groups if isinstance(g["lr"], torch.Tensor)]
    return out + [counter]


class TrainStep:
    """One train step as a captured program; see ``make_train_step``.

    Attributes:
        step: the int64 device step counter the learning rate and the geo
            ramp are computed from; set to ``state.step`` before each call.
        program: the captured ``_update`` (``runtime.graphs.Graphed``).
    """

    def __init__(self, state: TrainState, cfg: ColvoConfig):
        if state.mesh is not None and state.mesh.size > 1:
            raise ValueError("make_train_step captures one rank's step; under a mesh of "
                             f"{state.mesh.size} ranks the loss all-reduces through the host")
        self.state, self.cfg = state, cfg
        self.device = next(state.model.parameters()).device
        self.step = torch.zeros((), dtype=torch.int64, device=self.device)
        self.program = Graphed(self._body, device=self.device,
                               state=lambda: _mutable(self.state, self.step), name="train_step")

    def _body(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        cfg, state = self.cfg, self.state
        return _update(state, batch, cfg, geo_scale_t(cfg, self.step),
                       learning_rate_t(cfg, self.step, state.steps_per_epoch),
                       set_to_none=False)

    def __call__(self, state: TrainState, batch: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        if state is not self.state:
            raise ValueError("a train step trains the state it was made for")
        self.step.fill_(state.step)
        metrics = self.program(dict(batch))
        state.step += 1
        return metrics


def make_train_step(state: TrainState, cfg: ColvoConfig) -> TrainStep:
    """The train step as one program (port of
    ``colvo/runtime/train_step.py::make_train_step``, a ``jax.jit`` with the
    state donated).

    Returns ``step_fn(state, batch) → metrics``: the step of ``train_step``
    on ``batch`` ({frames, frames_clean, k}), with the learning rate and
    the geo ramp computed on the device from an int64 counter set to
    ``state.step``, and the gradients zeroed in place. On CUDA the first
    call of a batch shape warms up once on a side stream, puts back the
    weights, Adam's moments and the counter, and captures the step into a
    ``torch.cuda.CUDAGraph``; every call copies the batch into the graph's
    static inputs and replays it (``runtime.graphs``). The metrics are the
    graph's static outputs: the next call overwrites them, so a caller that
    keeps them past it copies them. ``step_fn`` trains the state it was
    made for; a new state (a restart) needs a new ``step_fn``. A capture
    that fails raises. Under a mesh of more than one rank it raises: the
    loss's all-reduces go through the host there, and ``train_step`` runs
    eagerly (``runtime/loop.py``).
    """
    return TrainStep(state, cfg)


class ScanTrain:
    """K train steps over a device-resident corpus as one chunk; see
    ``make_scan_train``.

    Attributes:
        step: the chunk's int64 step counter on the device; each step's
            learning rate and geo ramp are computed from it.
        indices: (n_steps, B) int64, the snippets the last chunk drew.
    """

    def __init__(self, state: TrainState, cfg: ColvoConfig, n_steps: int):
        if state.mesh is not None and state.mesh.size > 1:
            raise ValueError("make_scan_train runs on one rank; the reference's loop never "
                             "runs its scan under a mesh")
        self.state, self.cfg, self.n_steps = state, cfg, n_steps
        self.device = next(state.model.parameters()).device
        self.step = torch.zeros((), dtype=torch.int64, device=self.device)
        self.indices = torch.zeros((n_steps, cfg.data.batch_size), dtype=torch.int64,
                                   device=self.device)
        self.program: Optional[Graphed] = None
        self._inputs: Tuple = ()

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        """The chunk's CUDA graph once captured (None before, and on the CPU)."""
        progs = list(self.program.programs.values()) if self.program else []
        return progs[0].graph if progs else None

    @property
    def captured_launches(self) -> Dict[str, int]:
        """The kernel launches of one replay (CUDA)."""
        progs = list(self.program.programs.values()) if self.program else []
        return progs[0].launches if progs else {}

    def _steps(self, frames_u8: torch.Tensor, table: torch.Tensor, k: torch.Tensor,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """``n_steps`` steps, each: B snippet indices drawn with replacement,
        the uint8 gather and scale, the augmentation, forward, loss,
        backward, clip, Adam; the device counter advances. The gradients
        are zeroed in place, not freed, so that a capture reuses their
        memory."""
        cfg, state = self.cfg, self.state
        out = []
        for i in range(self.n_steps):
            idx = torch.randint(0, table.shape[0], (cfg.data.batch_size,), generator=generator,
                                device=self.device)
            self.indices[i].copy_(idx)
            out.append(_update(state, assemble(frames_u8, table, idx, k, generator, cfg.data),
                               cfg, geo_scale_t(cfg, self.step),
                               learning_rate_t(cfg, self.step, state.steps_per_epoch),
                               set_to_none=False))
            self.step.add_(1)
        return {key: torch.stack([m[key] for m in out]) for key in out[0]}

    def __call__(self, state: TrainState, frames_u8: torch.Tensor, table: torch.Tensor,
                 k: torch.Tensor, generator: torch.Generator):
        if state is not self.state:
            raise ValueError("a chunk trains the state it was made for")
        inputs = (frames_u8, table, k, generator)
        if self.program is None:
            # The corpus is read where it lies (it is not copied a call), so
            # the program is bound to these tensors and this generator.
            self._inputs = inputs
            self.program = Graphed(lambda: self._steps(*inputs), device=self.device,
                                   state=lambda: _mutable(self.state, self.step),
                                   generators=(generator,), name="scan_train")
        elif any(a is not b for a, b in zip(inputs, self._inputs)):
            raise ValueError("a captured chunk reads the frames, table, k and generator "
                             "it was captured with")
        self.step.fill_(state.step)
        metrics = {key: v.clone() for key, v in self.program().items()}
        state.step += self.n_steps
        return state, metrics


def make_scan_train(state: TrainState, cfg: ColvoConfig, n_steps: int) -> ScanTrain:
    """A chunk of ``n_steps`` train steps over a device-resident corpus (port
    of ``colvo/runtime/train_step.py::make_scan_train``).

    Returns ``chunk_fn(state, frames_u8, table, k, generator) → (state,
    metrics)``, each metric stacked to ``(n_steps,)``. Each step draws B
    snippet indices with replacement from ``generator`` (uniform, as the
    reference's ``lax.scan`` body), gathers and scales the uint8 frames,
    runs ``device_augment`` when ``cfg.data.augment``, then forward,
    ``snippet_loss``, backward, the global-norm clip and Adam, with the
    learning rate and the geo ramp computed on the device from the chunk's
    step counter.

    On CUDA the first call warms up one chunk on a side stream, restores
    the state and the generator, captures the ``n_steps`` steps into one
    ``torch.cuda.CUDAGraph`` (with ``generator`` registered with it) and
    replays it (``runtime.graphs``); each later call is one replay, so the
    host dispatches once a chunk, as the reference's jitted scan does. The
    program reads the tensors of the first call: later calls pass the same
    state, frames, table, k and generator. A capture that fails raises;
    nothing falls back to eager steps. On the CPU the same steps run
    eagerly. The metrics are the caller's own copies.
    """
    return ScanTrain(state, cfg, n_steps)
