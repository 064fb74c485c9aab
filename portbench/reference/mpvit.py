"""MPViT's depth encoder (MonoViT's) as plain float32 functions of a weight
dict, under ``reference/model.py``'s U-Net decoder, pose net and DCDP
fusion.

From ``mpvit.py`` of github.com/youngwanLEE/MPViT (``mpvit_small``) and
``networks/mpvit.py`` of github.com/zxcqlf/MonoViT: the stem of two
``Conv2d_BN`` (3×3/s2 to C₀/2, 3×3/s1 to C₀, Hardswish), then per stage
a chain of depthwise-separable patch embeddings (the first with stride
2), one MHCA encoder a path (a shared CPE and CRPE, blocks of LayerNorm →
factorized attention → proj and LayerNorm → MLP with exact GELU), the
InvRes local path on the first path's input, and a 1×1 ``Conv2d_BN`` +
Hardswish over the concatenation. Factorized attention is CoaT's:
d^−½·q·(softmax_N(k)ᵀ·v) + q ∘ CRPE(v), the CRPE depthwise 3×3, 5×5 and
7×7 over 2, 3 and 3 heads' channels of v. BatchNorm normalises by the
batch's statistics (``training``, momentum 0.1, eps 1e-5, the running
variance unbiased) or by the running ones.

Departures from MonoViT, the program's too: the U-Net decoder of
``reference/model.py`` in place of MonoViT's HR-Depth decoder; DCDP
fusion of the /32 feature (288 channels) into the pose net; the frame
entering as the ResNet path takes it, [0, 1] without ImageNet
normalisation; random weights; one learning rate for every weight.
``linear`` and every convolution apply ``quant`` to both operands when it
is given (the float8 control).

``spec(cfg)`` lists every weight's and BatchNorm buffer's name and shape
in the program's ``state_dict`` names; ``weights`` draws them from a seed
on the device; ``snippet_forward`` is the training forward over a snippet
batch, in the place of ``reference/model.py``'s, and ``pair_forward`` the
serving forward on running statistics.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.model import DEC, Quant, Weights, _encoder_spec, decoder, pose, scaled_disp

PRESETS: Dict[str, dict] = {
    "mpvit_s": dict(num_path=(2, 3, 3, 3), num_layers=(1, 3, 6, 3),
                    embed_dims=(64, 128, 216, 288), mlp_ratio=4, heads=8),
}
CRPE_WINDOW = ((3, 2), (5, 3), (7, 3))  # (kernel size, heads)
ENC = "depth.encoder."
BN_EPS, BN_MOMENTUM = 1e-5, 0.1


def channels(p: dict) -> Tuple[int, ...]:
    return tuple(p["embed_dims"]) + (p["embed_dims"][-1],)


# --- the weight list -------------------------------------------------------

def _encoder_items(p: dict) -> List[Tuple[str, tuple]]:
    items: List[Tuple[str, tuple]] = []
    dims = p["embed_dims"]

    def conv(name, ci, co, k, groups=1, bias=False):
        items.append((f"{ENC}{name}.weight", (co, ci // groups, k, k)))
        if bias:
            items.append((f"{ENC}{name}.bias", (co,)))

    def bn(name, c):
        items.extend([(f"{ENC}{name}.weight", (c,)), (f"{ENC}{name}.bias", (c,)),
                      (f"{ENC}{name}.running_mean", (c,)), (f"{ENC}{name}.running_var", (c,)),
                      (f"{ENC}{name}.num_batches_tracked", ())])

    def conv_bn(name, ci, co, k):
        conv(f"{name}.conv", ci, co, k)
        bn(f"{name}.bn", co)

    def linear(name, ci, co):
        items.extend([(f"{ENC}{name}.weight", (co, ci)), (f"{ENC}{name}.bias", (co,))])

    conv_bn("stem.0", 3, dims[0] // 2, 3)
    conv_bn("stem.1", dims[0] // 2, dims[0], 3)
    for i, c in enumerate(dims):
        for j in range(p["num_path"][i]):
            pc = f"patch_embed_stages.{i}.patch_embeds.{j}.patch_conv"
            conv(f"{pc}.dwconv", c, c, 3, groups=c)
            conv(f"{pc}.pwconv", c, c, 1)
            bn(f"{pc}.bn", c)
    for i, c in enumerate(dims):
        st, d = f"mhca_stages.{i}", c // p["heads"]
        for j in range(p["num_path"][i]):
            enc = f"{st}.mhca_blks.{j}"
            conv(f"{enc}.cpe.proj", c, c, 3, groups=c, bias=True)
            for w, (k, heads) in enumerate(CRPE_WINDOW):
                conv(f"{enc}.crpe.conv_list.{w}", heads * d, heads * d, k, groups=heads * d,
                     bias=True)
            for layer in range(p["num_layers"][i]):
                b = f"{enc}.MHCA_layers.{layer}"
                linear(f"{b}.factoratt_crpe.qkv", c, 3 * c)
                linear(f"{b}.factoratt_crpe.proj", c, c)
                linear(f"{b}.mlp.fc1", c, p["mlp_ratio"] * c)
                linear(f"{b}.mlp.fc2", p["mlp_ratio"] * c, c)
                for norm in ("norm1", "norm2"):
                    items.extend([(f"{ENC}{b}.{norm}.weight", (c,)),
                                  (f"{ENC}{b}.{norm}.bias", (c,))])
        conv_bn(f"{st}.InvRes.conv1", c, c, 1)
        conv(f"{st}.InvRes.dwconv", c, c, 3, groups=c)
        bn(f"{st}.InvRes.norm", c)
        conv_bn(f"{st}.InvRes.conv2", c, c, 1)
        conv_bn(f"{st}.aggregate", c * (p["num_path"][i] + 1), dims[min(i + 1, len(dims) - 1)], 1)
    return items


def spec(cfg) -> List[Tuple[str, tuple]]:
    """Every weight and BatchNorm buffer of the coupled model: (state_dict
    name, shape)."""
    enc = channels(PRESETS[cfg.depth_net])
    items = _encoder_items(PRESETS[cfg.depth_net])
    cin, j = enc[-1], 0
    for i in range(4, -1, -1):
        for ci in (cin, DEC[i] + (enc[i - 1] if i > 0 else 0)):
            items += [(f"depth.decoder.blocks.{j}.conv.weight", (DEC[i], ci, 3, 3)),
                      (f"depth.decoder.blocks.{j}.conv.bias", (DEC[i],))]
            j += 1
        cin = DEC[i]
    for i in range(cfg.n_scales):
        items += [(f"depth.decoder.dispconvs.{i}.weight", (1, DEC[i], 3, 3)),
                  (f"depth.decoder.dispconvs.{i}.bias", (1,))]
    items += _encoder_spec("pose_encoder.", 6, cfg)
    cin = 512
    if cfg.dcdp_fusion:
        for i in range(2):
            items += [(f"fusion.depth_proj.{i}.weight", (cfg.fusion_channels, enc[-1], 1, 1)),
                      (f"fusion.depth_proj.{i}.bias", (cfg.fusion_channels,))]
        cin += 2 * cfg.fusion_channels
    for name, ci, co, k in (("squeeze", cin, 256, 1), ("pose_0", 256, 256, 3),
                            ("pose_1", 256, 256, 3), ("pose_2", 256, 6, 1)):
        items += [(f"pose_decoder.{name}.weight", (co, ci, k, k)),
                  (f"pose_decoder.{name}.bias", (co,))]
    return items


def weights(model_cfg, seed: int, device) -> Weights:
    """{state_dict name: tensor on ``device``}: one ``torch.randn`` over
    every weight from a generator on the device, split in ``spec``'s order
    and scaled as the program initialises: linear layers std 0.02,
    convolutions LeCun-normal (fan-in cin·k·k over the groups); biases 0,
    LayerNorm, GroupNorm and BatchNorm 1 and 0; BatchNorm's running mean
    0, variance 1 and count 0 (int64)."""
    items = spec(model_cfg)
    total = sum(int(np.prod(s)) for _, s in items)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in items:
        n = int(np.prod(shape))
        x = flat[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[1]
        if leaf == "num_batches_tracked":
            x = torch.zeros(shape, device=device, dtype=torch.int64)
        elif leaf == "running_var" or (leaf == "weight" and len(shape) == 1):
            x = torch.ones(shape, device=device)
        elif leaf in ("bias", "running_mean"):
            x = torch.zeros(shape, device=device)
        elif len(shape) == 2:
            x = x * 0.02
        else:
            x = x * math.sqrt(1.0 / (shape[1] * shape[2] * shape[3]))
        out[name] = x
    return out


def buffers(names) -> List[str]:
    """The BatchNorm buffers among ``names``."""
    return [n for n in names if n.rsplit(".", 1)[1] in ("running_mean", "running_var",
                                                       "num_batches_tracked")]


# --- the forward -----------------------------------------------------------

def linear(x, w, b, quant: Quant = None):
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.linear(x, w, b)


def conv(x, w, b, stride: int = 1, groups: int = 1, quant: Quant = None):
    """A conv padded by k // 2 on every side."""
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, b, stride, w.shape[-1] // 2, groups=groups)


class Encoder:
    """The MPViT encoder over the weights ``p``; BatchNorm on the batch's
    statistics (``training``), whose updated running statistics land in
    ``self.running``, or on the running ones."""

    def __init__(self, p: Weights, cfg, quant: Quant = None, training: bool = True):
        self.p, self.s, self.quant, self.training = p, PRESETS[cfg.depth_net], quant, training
        self.running: Dict[str, torch.Tensor] = {}

    def w(self, name):
        return self.p[f"{ENC}{name}"]

    def bn(self, name, x):
        w, b = self.w(f"{name}.weight"), self.w(f"{name}.bias")
        rm, rv = self.w(f"{name}.running_mean"), self.w(f"{name}.running_var")
        if not self.training:
            return F.batch_norm(x, rm, rv, w, b, False, 0.0, BN_EPS)
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running[f"{ENC}{name}.running_mean"] = (
                (1 - BN_MOMENTUM) * rm + BN_MOMENTUM * mean.detach())
            self.running[f"{ENC}{name}.running_var"] = (
                (1 - BN_MOMENTUM) * rv + BN_MOMENTUM * var.detach() * n / (n - 1))
        shape = (1, -1, 1, 1)
        return (x - mean.view(shape)) / torch.sqrt(var.view(shape) + BN_EPS) * w.view(shape) \
            + b.view(shape)

    def conv(self, name, x, stride=1, groups=1, bias=False):
        return conv(x, self.w(f"{name}.weight"), self.w(f"{name}.bias") if bias else None,
                    stride, groups, self.quant)

    def conv_bn(self, name, x, stride=1, act=True):
        x = self.bn(f"{name}.bn", self.conv(f"{name}.conv", x, stride))
        return F.hardswish(x) if act else x

    def lin(self, name, x):
        return linear(x, self.w(f"{name}.weight"), self.w(f"{name}.bias"), self.quant)

    def ln(self, name, x):
        return F.layer_norm(x, (x.shape[-1],), self.w(f"{name}.weight"), self.w(f"{name}.bias"),
                            1e-6)

    def factor_attention(self, name, enc, t, hw):
        b, n, c = t.shape
        heads = self.s["heads"]
        d = c // heads
        qkv = self.lin(f"{name}.qkv", t).reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, heads, N, d)
        kv = torch.einsum("bhnk,bhnv->bhkv", torch.softmax(k, dim=2), v)
        att = torch.einsum("bhnk,bhkv->bhnv", q, kv)
        img = v.transpose(2, 3).reshape(b, c, *hw)
        parts, at = [], 0
        for w, (_, nh) in enumerate(CRPE_WINDOW):
            parts.append(self.conv(f"{enc}.crpe.conv_list.{w}", img[:, at:at + nh * d],
                                   groups=nh * d, bias=True))
            at += nh * d
        cv = torch.cat(parts, dim=1).reshape(b, heads, d, n).transpose(2, 3)
        out = d ** -0.5 * att + q * cv
        return self.lin(f"{name}.proj", out.transpose(1, 2).reshape(b, n, c))

    def mhca(self, enc, x, layers):
        b, c, h, w = x.shape
        t = x.flatten(2).transpose(1, 2)
        for layer in range(layers):
            img = t.transpose(1, 2).reshape(b, c, h, w)
            t = t + self.conv(f"{enc}.cpe.proj", img, groups=c, bias=True).flatten(2).transpose(1, 2)
            blk = f"{enc}.MHCA_layers.{layer}"
            t = t + self.factor_attention(f"{blk}.factoratt_crpe", enc,
                                          self.ln(f"{blk}.norm1", t), (h, w))
            m = self.lin(f"{blk}.mlp.fc2", F.gelu(self.lin(f"{blk}.mlp.fc1",
                                                           self.ln(f"{blk}.norm2", t))))
            t = t + m
        return t.transpose(1, 2).reshape(b, c, h, w)

    def __call__(self, x) -> List[torch.Tensor]:
        s = self.s
        x = self.conv_bn("stem.1", self.conv_bn("stem.0", x, 2))
        feats = [x]
        for i, c in enumerate(s["embed_dims"]):
            inputs = []
            for j in range(s["num_path"][i]):
                pc = f"patch_embed_stages.{i}.patch_embeds.{j}.patch_conv"
                x = self.conv(f"{pc}.dwconv", x, 2 if j == 0 else 1, groups=c)
                x = F.hardswish(self.bn(f"{pc}.bn", self.conv(f"{pc}.pwconv", x)))
                inputs.append(x)
            st = f"mhca_stages.{i}"
            y = self.conv_bn(f"{st}.InvRes.conv1", inputs[0])
            y = F.hardswish(self.bn(f"{st}.InvRes.norm", self.conv(f"{st}.InvRes.dwconv", y,
                                                                    groups=c)))
            outs = [inputs[0] + self.conv_bn(f"{st}.InvRes.conv2", y, act=False)]
            outs += [self.mhca(f"{st}.mhca_blks.{j}", xi, s["num_layers"][i])
                     for j, xi in enumerate(inputs)]
            x = self.conv_bn(f"{st}.aggregate", torch.cat(outs, dim=1))
            feats.append(x)
        return feats


def depth_net(p: Weights, x, cfg, quant: Quant = None, training: bool = True,
              running: Optional[dict] = None):
    """[0, 1] frames (N, 3, H, W) → ({scale: disparity}, the /32 feature);
    with ``running`` a dict, the updated running statistics land in it."""
    enc = Encoder(p, cfg, quant, training)
    feats = enc(x)
    if running is not None:
        running.update(enc.running)
    return decoder(p, feats, cfg, quant), feats[-1]


def snippet_forward(p: Weights, frames: torch.Tensor, cfg, quant: Quant = None,
                    running: Optional[dict] = None):
    """(B, F, H, W, 3) frames, index 0 the target → (per-frame {scale: (B,
    h, w, 1)} disparities, (B, F − 1, 6) target→source poses); one depth
    pass over the B·F frames, whose batch statistics BatchNorm takes."""
    b, n, h, w, _ = frames.shape
    x = frames.reshape(b * n, h, w, 3).permute(0, 3, 1, 2)
    disp, bneck = depth_net(p, x, cfg, quant, running=running)
    disps = [{s: v.reshape(b, n, *v.shape[1:])[:, i].permute(0, 2, 3, 1)
              for s, v in disp.items()} for i in range(n)]
    x = x.reshape(b, n, *x.shape[1:])
    bneck = bneck.reshape(b, n, *bneck.shape[1:])
    srcs = range(1, n)
    aa, tr = pose(p, torch.cat([x[:, 0]] * (n - 1)), torch.cat([x[:, s] for s in srcs]),
                  torch.cat([bneck[:, 0]] * (n - 1)), torch.cat([bneck[:, s] for s in srcs]),
                  cfg, quant)
    poses = torch.cat([aa, tr], dim=-1).reshape(n - 1, b, 6).transpose(0, 1)
    return disps, poses


def pair_forward(p: Weights, img_a, img_b, cfg, quant: Quant = None, symmetric=False):
    """``reference/model.py``'s serving forward on running statistics."""
    disp, bneck = depth_net(p, torch.cat([img_a, img_b]), cfg, quant, training=False)
    sd_a, sd_b = scaled_disp(disp[0][:, 0], cfg).chunk(2)
    ba, bb = bneck.chunk(2)
    aa, tr = pose(p, img_a, img_b, ba, bb, cfg, quant)
    if symmetric:
        aa_r, _ = pose(p, img_b, img_a, bb, ba, cfg, quant)
        aa = 0.5 * (aa - aa_r)
    return sd_a, sd_b, aa, tr
