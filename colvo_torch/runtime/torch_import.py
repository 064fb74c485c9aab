"""Family-checkpoint import (port of ``colvo/runtime/torch_import.py``).

The reference's published weights are the family's PyTorch format: four
per-module state dicts, ``encoder.pth`` / ``depth.pth`` (torchvision ResNet
and a Monodepth2-style depth decoder) and ``pose_encoder.pth`` /
``pose.pth`` (a 6-channel ResNet and the pose decoder). This module maps
them into a port ``state_dict`` of the ``model.norm="none"`` model: each
BatchNorm folds into the conv before it (:func:`fold_batchnorm`), and the
port's convs are OIHW as torch's are, so nothing is transposed. The key
layout is the family's (Monodepth2 ``resnet_encoder.py`` /
``depth_decoder.py`` / ``pose_decoder.py`` naming).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

# blocks per stage (mirrors colvo_torch.models.encoder._STAGES)
_STAGES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


def fold_batchnorm(
    conv_w: torch.Tensor, bn_gamma, bn_beta, bn_mean, bn_var, eps: float = 1e-5
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold BatchNorm statistics into the preceding OIHW conv:
    ``w' = w·γ/√(σ²+ε)`` per output channel, ``b' = β − γ·μ/√(σ²+ε)``.
    Returns (folded_w, folded_b) in ``conv_w``'s dtype."""
    scale = bn_gamma / torch.sqrt(bn_var + eps)
    w = conv_w * scale[:, None, None, None]
    b = bn_beta - bn_mean * scale
    return w.to(conv_w.dtype), b.to(conv_w.dtype)


def _t(x) -> torch.Tensor:
    """A state-dict entry as a float32 CPU tensor."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def _strip_prefix(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    return {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}


def _conv_bn(sd: Mapping[str, Any], conv_key: str, bn_key: str, out: Dict[str, Any],
             name: str) -> None:
    """``out[name.weight]``, ``out[name.bias]``: a torch conv followed by a
    BatchNorm, folded."""
    out[f"{name}.weight"], out[f"{name}.bias"] = fold_batchnorm(
        _t(sd[f"{conv_key}.weight"]),
        *(_t(sd[f"{bn_key}.{k}"]) for k in ("weight", "bias", "running_mean", "running_var")),
    )


def import_resnet_encoder(
    state_dict: Mapping[str, Any], num_layers: int = 18
) -> Dict[str, Any]:
    """torchvision ResNet-18/34 state dict → the port's ``ResNetEncoder``
    (``norm="none"``) entries (``stem.*``, ``blocks.<i>.{conv1,conv2,down}.*``),
    BatchNorm folded into conv weight and bias.

    Accepts both bare torchvision keys (``conv1.weight``) and the family's
    wrapped form (``encoder.conv1.weight``); bookkeeping entries and the
    classifier head (``fc.*``) are ignored.
    """
    sd = _strip_prefix(state_dict, "encoder.")
    out: Dict[str, Any] = {}
    _conv_bn(sd, "conv1", "bn1", out, "stem")
    flat_block = 0
    for stage_idx, blocks in enumerate(_STAGES[num_layers]):
        for block_idx in range(blocks):
            t = f"layer{stage_idx + 1}.{block_idx}"
            for n in (1, 2):
                _conv_bn(sd, f"{t}.conv{n}", f"{t}.bn{n}", out, f"blocks.{flat_block}.conv{n}")
            if f"{t}.downsample.0.weight" in sd:
                _conv_bn(sd, f"{t}.downsample.0", f"{t}.downsample.1", out,
                         f"blocks.{flat_block}.down")
            flat_block += 1
    return out


def import_depth_decoder(
    state_dict: Mapping[str, Any], n_scales: int = 4
) -> Dict[str, Any]:
    """Family depth-decoder state dict → the port's ``DepthDecoder``
    entries: ``decoder.{0..9}`` are the ten upconv ConvBlocks in top-down
    order (``blocks.{0..9}.conv``), ``decoder.{10..}`` the disparity heads
    of scales 0..n−1 (``dispconvs.<s>``)."""
    out: Dict[str, Any] = {}
    for i in range(10):
        for leaf in ("weight", "bias"):
            out[f"blocks.{i}.conv.{leaf}"] = _t(state_dict[f"decoder.{i}.conv.conv.{leaf}"])
    for s in range(n_scales):
        for leaf in ("weight", "bias"):
            out[f"dispconvs.{s}.{leaf}"] = _t(state_dict[f"decoder.{10 + s}.conv.{leaf}"])
    return out


def import_pose_decoder(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Family pose-decoder state dict → the port's ``PoseDecoder`` entries.

    Family layout: ``net.0`` squeeze 1×1, ``net.1``/``net.2`` 3×3 convs,
    ``net.3`` the 6·K-channel head (K poses a pass; family default 2). The
    port's head predicts the single target→source pose, so only the first
    6 output channels are taken, the slice the family's own VO evaluation
    uses (pose index 0).
    """
    out: Dict[str, Any] = {}
    for i, name in enumerate(("squeeze", "pose_0", "pose_1", "pose_2")):
        w, b = _t(state_dict[f"net.{i}.weight"]), _t(state_dict[f"net.{i}.bias"])
        if name == "pose_2" and w.shape[0] != 6:
            if w.shape[0] % 6:
                raise ValueError(f"net.3 has {w.shape[0]} output channels, not 6·K")
            w, b = w[:6], b[:6]
        out[f"{name}.weight"], out[f"{name}.bias"] = w, b
    return out


def import_family_checkpoint(
    params_template: Any,
    encoder_sd: Mapping[str, Any],
    depth_sd: Mapping[str, Any],
    pose_encoder_sd: Optional[Mapping[str, Any]] = None,
    pose_sd: Optional[Mapping[str, Any]] = None,
    num_layers: int = 18,
    n_scales: int = 4,
) -> Any:
    """Fill a port ``state_dict`` template with family torch weights.

    ``params_template`` is ``ColVOModel(cfg).state_dict()`` for a
    ``ModelConfig(norm="none")`` model. Modules the checkpoint has are
    replaced; what the family lacks (the DCDP fusion convs, and the pose
    branch of a depth-only release) keeps its template values. Imported
    entries are checked against the template's keys and shapes. A template
    with a DPT depth net (``model.depth_net``) raises ValueError: the
    family's depth checkpoints are ResNet and Monodepth2 modules.
    """
    if not any(k.startswith("depth.encoder.") for k in params_template):
        raise ValueError("the template's depth net is not the ResNet one "
                         "(model.depth_net='resnet'): a family checkpoint has no weights for it")
    out = {k: v.clone() for k, v in params_template.items()}
    parts = [("depth.encoder.", import_resnet_encoder(encoder_sd, num_layers)),
             ("depth.decoder.", import_depth_decoder(depth_sd, n_scales))]
    if pose_encoder_sd is not None:
        parts.append(("pose_encoder.", import_resnet_encoder(pose_encoder_sd, num_layers)))
    if pose_sd is not None:
        parts.append(("pose_decoder.", import_pose_decoder(pose_sd)))
    for prefix, imported in parts:
        template = {k[len(prefix):]: v for k, v in params_template.items() if k.startswith(prefix)}
        for k, v in _checked(template, imported).items():
            out[prefix + k] = v.to(template[k].dtype)
    return out


def _checked(template: Mapping[str, Any], imported: Dict[str, Any]) -> Dict[str, Any]:
    """Verify the imported entries' keys and shapes match the template's."""
    missing = sorted(set(template) - set(imported))
    extra = sorted(set(imported) - set(template))
    if missing or extra:
        raise ValueError(
            f"family checkpoint mismatch: missing={missing[:5]} extra={extra[:5]}"
        )
    for k, t in template.items():
        if tuple(t.shape) != tuple(imported[k].shape):
            raise ValueError(f"{k}: template {tuple(t.shape)} vs import "
                             f"{tuple(imported[k].shape)}")
    return imported


def load_family_checkpoint_dir(path: str) -> Dict[str, Dict[str, Any]]:
    """Load the family's four ``.pth`` files from a directory.

    Returns ``{"encoder": sd, "depth": sd, "pose_encoder": sd?, "pose": sd?}``
    (the pose files are optional: depth-only releases exist in the family).
    """
    out: Dict[str, Dict[str, Any]] = {}
    for name in ("encoder", "depth", "pose_encoder", "pose"):
        f = os.path.join(path, f"{name}.pth")
        if os.path.exists(f):
            out[name] = torch.load(f, map_location="cpu", weights_only=True)
        elif name in ("encoder", "depth"):
            raise FileNotFoundError(f)
    return out
