"""Train step, training loop, checkpoints, metrics, inference runner and
weight conversion."""

from colvo_torch.runtime.checkpoint import CheckpointManager
from colvo_torch.runtime.convert import export_npz, flax_params, load_npz, params_from_flax
from colvo_torch.runtime.infer import InferenceRunner
from colvo_torch.runtime.loop import train
from colvo_torch.runtime.metrics import AsyncMetricsLogger, MetricsWriter
from colvo_torch.runtime.train_step import (
    TrainState,
    clip_by_global_norm,
    geo_scale,
    init_state,
    geo_scale_t,
    learning_rate,
    learning_rate_t,
    loss_fn,
    make_scan_train,
    make_train_step,
    to_device,
    train_step,
)

__all__ = [
    "TrainState",
    "init_state",
    "train_step",
    "make_scan_train",
    "make_train_step",
    "loss_fn",
    "learning_rate",
    "geo_scale",
    "learning_rate_t",
    "geo_scale_t",
    "clip_by_global_norm",
    "to_device",
    "train",
    "CheckpointManager",
    "MetricsWriter",
    "AsyncMetricsLogger",
    "InferenceRunner",
    "params_from_flax",
    "export_npz",
    "load_npz",
    "flax_params",
]
