"""Train step, inference runner and weight conversion."""

from colvo_torch.runtime.convert import export_npz, flax_params, params_from_flax
from colvo_torch.runtime.infer import InferenceRunner
from colvo_torch.runtime.train_step import (
    TrainState,
    clip_by_global_norm,
    geo_scale,
    init_state,
    learning_rate,
    loss_fn,
    to_device,
    train_step,
)

__all__ = [
    "TrainState",
    "init_state",
    "train_step",
    "loss_fn",
    "learning_rate",
    "geo_scale",
    "clip_by_global_norm",
    "to_device",
    "InferenceRunner",
    "params_from_flax",
    "export_npz",
    "flax_params",
]
