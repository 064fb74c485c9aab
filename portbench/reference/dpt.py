"""Depth Anything V2's depth network (DINOv2 ViT and DPT head) as plain
float32 functions of a weight dict, with the ResNet pose net of
``reference/model.py``.

From ``depth_anything_v2/dinov2.py`` and ``dpt.py`` of
github.com/DepthAnything/Depth-Anything-V2, with the program's two
departures (``colvo_torch/models/dpt.py``): a sigmoid for the last ReLU,
and a frame whose side is not a multiple of 14 resized bilinearly to the
nearest one before the encoder, the head upsampling to the frame's size.
Attention is the plain softmax(q·kᵀ/√d)·v. ``linear`` and every
convolution, the transposed ones too, apply ``quant`` to both operands
when it is given (the float8 control).

``spec(cfg)`` lists every weight's name and shape in the program's
``state_dict`` names; ``weights`` draws them from a seed on the device;
``snippet_forward`` is the training forward over a snippet batch, in the
place of ``reference/model.py``'s.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.model import Quant, Weights, _encoder_spec, pose

PATCH, POS_GRID, POS_OFFSET = 14, 37, 0.1
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)

# DA-V2's published sizes (run.py's model_configs, dpt.py's
# intermediate_layer_idx), by the model.depth_net value.
PRESETS: Dict[str, dict] = {
    "dpt_vits14": dict(dim=384, depth=12, heads=6, taps=(2, 5, 8, 11), features=64,
                       out_channels=(48, 96, 192, 384)),
    "dpt_vitb14": dict(dim=768, depth=12, heads=12, taps=(2, 5, 8, 11), features=128,
                       out_channels=(96, 192, 384, 768)),
    "dpt_vitl14": dict(dim=1024, depth=24, heads=16, taps=(4, 11, 17, 23), features=256,
                       out_channels=(256, 512, 1024, 1024)),
}
VIT = "depth.pretrained."
HEAD = "depth_head."


# --- the weight list -------------------------------------------------------

def _head_spec(p: dict) -> List[Tuple[str, tuple]]:
    f, c, pre = p["features"], p["out_channels"], "depth." + HEAD
    items = []

    def conv(name, ci, co, k, bias=True):
        items.append((f"{pre}{name}.weight", (co, ci, k, k)))
        if bias:
            items.append((f"{pre}{name}.bias", (co,)))

    for i, ci in enumerate(c):
        conv(f"projects.{i}", p["dim"], ci, 1)
    for i, k in ((0, 4), (1, 2)):
        items += [(f"{pre}resize_layers.{i}.weight", (c[i], c[i], k, k)),
                  (f"{pre}resize_layers.{i}.bias", (c[i],))]
    conv("resize_layers.3", c[3], c[3], 3)
    for i, ci in enumerate(c, start=1):
        conv(f"scratch.layer{i}_rn", ci, f, 3, bias=False)
    for i in range(1, 5):
        for unit in ("resConfUnit1", "resConfUnit2") if i < 4 else ("resConfUnit2",):
            for j in (1, 2):
                conv(f"scratch.refinenet{i}.{unit}.conv{j}", f, f, 3)
        conv(f"scratch.refinenet{i}.out_conv", f, f, 1)
    conv("scratch.output_conv1", f, f // 2, 3)
    conv("scratch.output_conv2.0", f // 2, 32, 3)
    conv("scratch.output_conv2.2", 32, 1, 1)
    return items


def spec(cfg) -> List[Tuple[str, tuple]]:
    """Every weight of the coupled model: (state_dict name, shape)."""
    p = PRESETS[cfg.depth_net]
    d = p["dim"]
    items = [(f"{VIT}cls_token", (1, 1, d)), (f"{VIT}pos_embed", (1, POS_GRID ** 2 + 1, d)),
             (f"{VIT}patch_embed.proj.weight", (d, 3, PATCH, PATCH)),
             (f"{VIT}patch_embed.proj.bias", (d,))]
    for i in range(p["depth"]):
        b = f"{VIT}blocks.{i}."
        for name, shape in (("norm1", (d,)), ("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                            ("norm2", (d,)), ("mlp.fc1", (4 * d, d)), ("mlp.fc2", (d, 4 * d))):
            items += [(f"{b}{name}.weight", shape), (f"{b}{name}.bias", (shape[0],))]
            if name in ("attn.proj", "mlp.fc2"):
                items.append((f"{b}ls{1 if name == 'attn.proj' else 2}.gamma", (d,)))
    items += [(f"{VIT}norm.weight", (d,)), (f"{VIT}norm.bias", (d,))]
    items += _head_spec(p)
    items += _encoder_spec("pose_encoder.", 6, cfg)
    for name, ci, co, k in (("squeeze", 512, 256, 1), ("pose_0", 256, 256, 3),
                            ("pose_1", 256, 256, 3), ("pose_2", 256, 6, 1)):
        items += [(f"pose_decoder.{name}.weight", (co, ci, k, k)),
                  (f"pose_decoder.{name}.bias", (co,))]
    return items


def weights(model_cfg, seed: int, device) -> Weights:
    """{state_dict name: float32 tensor on ``device``}: one ``torch.randn``
    over every weight from a generator on the device, split in ``spec``'s
    order and scaled as the program initialises: linear layers std 0.02,
    the position table std 0.02, the cls token std 1e-6, convolutions
    LeCun-normal (fan-in cin·k·k, for a transposed one too); biases 0,
    LayerNorm, GroupNorm and LayerScale 1 and 0."""
    items = spec(model_cfg)
    total = sum(int(np.prod(s)) for _, s in items)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in items:
        n = int(np.prod(shape))
        x = flat[at:at + n].view(shape)
        at += n
        module, leaf = name.rsplit(".", 1)
        if leaf == "gamma" or (leaf == "weight" and len(shape) == 1):
            x = torch.ones(shape, device=device)  # LayerScale, LayerNorm, GroupNorm
        elif leaf == "bias":
            x = torch.zeros(shape, device=device)
        elif leaf == "cls_token":
            x = x * 1e-6
        elif leaf == "pos_embed" or len(shape) == 2:
            x = x * 0.02
        else:
            cin = shape[0] if "resize_layers.0" in module or "resize_layers.1" in module \
                else shape[1]
            x = x * math.sqrt(1.0 / (cin * shape[2] * shape[3]))
        out[name] = x
    return out


# --- the forward -----------------------------------------------------------

def linear(x, w, b, quant: Quant = None):
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.linear(x, w, b)


def conv(x, w, b, stride: int = 1, pad: int = 0, quant: Quant = None):
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, b, stride, pad)


def conv_transpose(x, w, b, quant: Quant = None):
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv_transpose2d(x, w, b, stride=w.shape[-1])


def grid_size(size: int) -> int:
    """Patches along a side: the nearest multiple of 14, ties up, at least 1."""
    return max(1, math.floor(size / PATCH + 0.5))


def pos_table(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """DINOv2's ``interpolate_pos_encoding``: bicubic, the scale from the
    grid plus 0.1; the table itself at 37×37."""
    if gh == gw == POS_GRID:
        return pos
    d = pos.shape[-1]
    grid = pos[:, 1:].reshape(1, POS_GRID, POS_GRID, d).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((gh + POS_OFFSET) / POS_GRID,
                                             (gw + POS_OFFSET) / POS_GRID), mode="bicubic")
    return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, d)], dim=1)


def vit(p: Weights, x, cfg, quant: Quant = None) -> List[torch.Tensor]:
    """ImageNet-normalised (N, 3, 14·gh, 14·gw) → the taps' LayerNormed
    patch tokens (N, gh·gw, dim)."""
    s = PRESETS[cfg.depth_net]
    d, heads = s["dim"], s["heads"]
    gh, gw = x.shape[2] // PATCH, x.shape[3] // PATCH
    t = conv(x, p[f"{VIT}patch_embed.proj.weight"], p[f"{VIT}patch_embed.proj.bias"], PATCH, 0,
             quant).flatten(2).transpose(1, 2)
    t = torch.cat([p[f"{VIT}cls_token"].expand(len(t), -1, -1), t], dim=1)
    t = t + pos_table(p[f"{VIT}pos_embed"], gh, gw)
    n = t.shape[1]

    def ln(name, x):
        return F.layer_norm(x, (d,), p[f"{name}.weight"], p[f"{name}.bias"], 1e-6)

    def lin(name, x):
        return linear(x, p[f"{name}.weight"], p[f"{name}.bias"], quant)

    out = []
    for i in range(s["depth"]):
        b = f"{VIT}blocks.{i}."
        qkv = lin(b + "attn.qkv", ln(b + "norm1", t)).reshape(len(t), n, 3, heads, d // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(d // heads), dim=-1) @ v
        att = lin(b + "attn.proj", att.transpose(1, 2).reshape(len(t), n, d))
        t = t + att * p[b + "ls1.gamma"]
        m = lin(b + "mlp.fc2", F.gelu(lin(b + "mlp.fc1", ln(b + "norm2", t))))
        t = t + m * p[b + "ls2.gamma"]
        if i in s["taps"]:
            out.append(ln(f"{VIT}norm", t)[:, 1:])
    return out


def dpt_head(p: Weights, taps, gh: int, gw: int, size, cfg, quant: Quant = None):
    """The taps' tokens → sigmoid disparity (N, 1, *size)."""
    pre = "depth." + HEAD

    def cv(name, x, stride=1, pad=None):
        w = p[f"{pre}{name}.weight"]
        return conv(x, w, p.get(f"{pre}{name}.bias"), stride,
                    w.shape[-1] // 2 if pad is None else pad, quant)

    def rcu(name, x):
        return cv(f"{name}.conv2", F.relu(cv(f"{name}.conv1", F.relu(x)))) + x

    def fuse(i, x, skip=None, size=None):
        name = f"scratch.refinenet{i}"
        if skip is not None:
            x = x + rcu(f"{name}.resConfUnit1", skip)
        x = rcu(f"{name}.resConfUnit2", x)
        x = F.interpolate(x, size=size, scale_factor=None if size else 2, mode="bilinear",
                          align_corners=True)
        return cv(f"{name}.out_conv", x)

    layers = []
    for i, t in enumerate(taps):
        x = cv(f"projects.{i}", t.transpose(1, 2).reshape(len(t), t.shape[2], gh, gw))
        if i < 2:
            x = conv_transpose(x, p[f"{pre}resize_layers.{i}.weight"],
                               p[f"{pre}resize_layers.{i}.bias"], quant)
        elif i == 3:
            x = cv("resize_layers.3", x, 2)
        layers.append(cv(f"scratch.layer{i + 1}_rn", x))
    l1, l2, l3, l4 = layers
    path = fuse(4, l4, size=l3.shape[2:])
    path = fuse(3, path, l3, l2.shape[2:])
    path = fuse(2, path, l2, l1.shape[2:])
    path = fuse(1, path, l1)
    out = F.interpolate(cv("scratch.output_conv1", path), size=size, mode="bilinear",
                        align_corners=True)
    out = cv("scratch.output_conv2.2", F.relu(cv("scratch.output_conv2.0", out)))
    return torch.sigmoid(out)


def depth_net(p: Weights, img, cfg, quant: Quant = None):
    """[0, 1] frames (N, 3, H, W) → ({0: disparity (N, 1, H, W)}, the last
    tap's tokens)."""
    h, w = img.shape[2], img.shape[3]
    gh, gw = grid_size(h), grid_size(w)
    mean = img.new_tensor(MEAN).view(1, 3, 1, 1)
    std = img.new_tensor(STD).view(1, 3, 1, 1)
    x = (img - mean) / std
    if (gh * PATCH, gw * PATCH) != (h, w):
        x = F.interpolate(x, size=(gh * PATCH, gw * PATCH), mode="bilinear", align_corners=False)
    taps = vit(p, x, cfg, quant)
    return {0: dpt_head(p, taps, gh, gw, (h, w), cfg, quant)}, taps[-1]


def snippet_forward(p: Weights, frames: torch.Tensor, cfg, quant: Quant = None):
    """(B, F, H, W, 3) frames, index 0 the target → (per-frame {0: (B, H,
    W, 1)} disparities, (B, F − 1, 6) target→source poses); the pose net
    without DCDP fusion."""
    b, n, h, w, _ = frames.shape
    # NCHW laid out as the program lays it out: the same convolution
    # algorithms, so a float32 run on the CPU rounds as the program does
    x = frames.reshape(b * n, h, w, 3).permute(0, 3, 1, 2).contiguous()
    disp, _ = depth_net(p, x, cfg, quant)
    disps = [{s: v.reshape(b, n, *v.shape[1:])[:, i].permute(0, 2, 3, 1)
              for s, v in disp.items()} for i in range(n)]
    x = x.reshape(b, n, *x.shape[1:])
    srcs = range(1, n)
    aa, tr = pose(p, torch.cat([x[:, 0]] * (n - 1)), torch.cat([x[:, s] for s in srcs]),
                  None, None, cfg, quant)
    poses = torch.cat([aa, tr], dim=-1).reshape(n - 1, b, 6).transpose(0, 1)
    return disps, poses
