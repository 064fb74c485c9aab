"""Weights across the two packages: the reference's flat ``.npz`` export
(Flax parameter paths joined with ``/``, conv kernels HWIO) ⇄ the port's
``state_dict`` (conv weights OIHW). A DPT depth net (``model.depth_net``
other than ``"resnet"``) has no counterpart in the JAX package, and its
weights are refused both ways."""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping

import numpy as np
import torch

from colvo_torch.config import ModelConfig
from colvo_torch.models import ColVOModel

# The DPT depth net's modules (``models/dpt.py``).
_DPT_PREFIXES = ("depth.pretrained.", "depth.depth_head.")
_NO_DPT = "the JAX package has no DPT depth net, so its weights have no .npz layout"

# Port module path → Flax module path, applied in order.
_RULES = (
    (r"^depth\.", "depth/"),
    (r"\.blocks\.(\d+)\.conv1$", r"/BasicBlock_\1/Conv_0"),
    (r"\.blocks\.(\d+)\.conv2$", r"/BasicBlock_\1/Conv_1"),
    (r"\.blocks\.(\d+)\.down$", r"/BasicBlock_\1/Conv_2"),
    (r"\.blocks\.(\d+)\.norm1$", r"/BasicBlock_\1/_Norm_0/GroupNorm_0"),
    (r"\.blocks\.(\d+)\.norm2$", r"/BasicBlock_\1/_Norm_1/GroupNorm_0"),
    (r"\.blocks\.(\d+)\.down_norm$", r"/BasicBlock_\1/_Norm_2/GroupNorm_0"),
    (r"\.stem$", "/Conv_0"),
    (r"\.stem_norm$", "/_Norm_0/GroupNorm_0"),
    (r"decoder\.blocks\.(\d+)\.conv$", r"decoder/ConvBlock_\1/Conv_0"),
    (r"decoder\.dispconvs\.(\d+)$", r"decoder/dispconv_\1"),
    (r"^fusion\.depth_proj\.(\d+)$", r"fusion/depth_proj_\1"),
    (r"^pose_decoder\.", "pose_decoder/"),
)


def _flax_module(path: str) -> str:
    for pat, rep in _RULES:
        path = re.sub(pat, rep, path)
    return "params/" + path


def _flax_leaf(name: str, value: torch.Tensor) -> str:
    """Flax path and kind for one port parameter name."""
    module, _, leaf = name.rpartition(".")
    if leaf == "weight":
        leaf = "kernel" if value.ndim == 4 else "scale"
    return f"{_flax_module(module)}/{leaf}"


def _to_port(value: np.ndarray) -> torch.Tensor:
    t = torch.tensor(np.asarray(value, dtype=np.float32))
    return t.permute(3, 2, 0, 1).contiguous() if t.ndim == 4 else t


def _to_flax(value: torch.Tensor) -> np.ndarray:
    v = value.detach().float().cpu()
    return (v.permute(2, 3, 1, 0) if v.ndim == 4 else v).numpy()


def _template(model_cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        return ColVOModel(model_cfg).state_dict()


def params_from_flax(
    flat: Mapping[str, np.ndarray], model_cfg: ModelConfig | None = None
) -> Dict[str, torch.Tensor]:
    """Flat Flax params (``load_params``/``export_params`` keys) → the
    port's ``state_dict``. Raises on any key left over, missing, or of the
    wrong shape for ``model_cfg`` (default ``ModelConfig()``); a DPT
    depth net raises ValueError."""
    model_cfg = model_cfg or ModelConfig()
    if model_cfg.depth_net != "resnet":
        raise ValueError(f"model.depth_net={model_cfg.depth_net!r}: {_NO_DPT}")
    template = _template(model_cfg)
    out: Dict[str, torch.Tensor] = {}
    used = set()
    missing = []
    for name, ref in template.items():
        key = _flax_leaf(name, ref)
        if key not in flat:
            missing.append(f"{key} (for {name})")
            continue
        t = _to_port(flat[key])
        if t.shape != ref.shape:
            raise ValueError(f"{key}: shape {tuple(t.shape)} != expected {tuple(ref.shape)}")
        out[name] = t
        used.add(key)
    left = sorted(set(flat) - used)
    if missing or left:
        raise KeyError(f"flax params do not match the port: missing {missing}, left over {left}")
    return out


def flax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A port ``state_dict`` → flat Flax params (the inverse of
    :func:`params_from_flax`); a DPT depth net's raises ValueError."""
    dpt = [k for k in state_dict if k.startswith(_DPT_PREFIXES)]
    if dpt:
        raise ValueError(f"{dpt[0]}, ...: {_NO_DPT}")
    return {_flax_leaf(k, v): _to_flax(v) for k, v in state_dict.items()}


def export_npz(state_dict: Mapping[str, torch.Tensor], path: str) -> str:
    """Write a port ``state_dict`` as the reference's flat ``.npz`` export
    (``colvo.runtime.checkpoint.load_params`` reads it). Returns the path."""
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez(path, **flax_params(state_dict))
    return path


def load_npz(path: str, model_cfg: ModelConfig | None = None) -> Dict[str, torch.Tensor]:
    """Read a flat ``.npz`` (written by :func:`export_npz` or the
    reference's ``export_params``) into a port ``state_dict`` through
    :func:`params_from_flax`. A path without the suffix finds the file
    ``np.savez`` wrote."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path += ".npz"
    with np.load(path) as data:
        return params_from_flax({k: data[k] for k in data.files}, model_cfg)
