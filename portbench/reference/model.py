"""The ColVO networks as plain functions of a weight dict (float32).

Two geometries, as the configuration's ``model.norm`` says:

* ``"group"``: bias-free convolutions padded as XLA's ``SAME`` (on even
  inputs the 7×7/s2 stem pads (2, 3), a 3×3/s2 conv (0, 1)), each followed
  by GroupNorm with ``min(max(8, C // 16), C)`` groups and eps 1e-6; the
  decoder pads its 3×3 convs by one zero.
* ``"none"`` (Monodepth2's layout with BatchNorm folded away): convolutions
  with a bias padded ``k // 2`` on every side; the decoder reflects the
  input by one pixel.

``spec(model_cfg)`` lists every weight's name and shape, in the names of
the program's ``state_dict``; ``snippet_forward`` is the training forward
over a snippet batch and ``pair_forward`` the serving forward of a frame
pair. ``conv`` applies ``quant`` to both operands when it is given (the
float8 control).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

STAGES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
ENC = (64, 64, 128, 256, 512)
DEC = (16, 32, 64, 128, 256)

Weights = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _groups(c: int) -> int:
    return min(max(8, c // 16), c)


def _same(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


# --- the weight list -------------------------------------------------------

def _enc_blocks(num_layers: int):
    """(index, cin, cout, stride) of each BasicBlock."""
    out, cin, i = [], 64, 0
    for stage, (n, width) in enumerate(zip(STAGES[num_layers], ENC[1:])):
        for j in range(n):
            out.append((i, cin, width, 2 if stage > 0 and j == 0 else 1))
            cin, i = width, i + 1
    return out


def _encoder_spec(prefix: str, cin: int, cfg) -> List[Tuple[str, tuple]]:
    norm = cfg.norm == "group"
    items = []

    def conv(name, ci, co, k):
        items.append((f"{prefix}{name}.weight", (co, ci, k, k)))
        if not norm:
            items.append((f"{prefix}{name}.bias", (co,)))

    def gn(name, c):
        if norm:
            items.extend([(f"{prefix}{name}.weight", (c,)), (f"{prefix}{name}.bias", (c,))])

    conv("stem", cin, 64, 7)
    gn("stem_norm", 64)
    for i, ci, co, stride in _enc_blocks(cfg.num_layers):
        conv(f"blocks.{i}.conv1", ci, co, 3)
        gn(f"blocks.{i}.norm1", co)
        conv(f"blocks.{i}.conv2", co, co, 3)
        gn(f"blocks.{i}.norm2", co)
        if stride != 1 or ci != co:
            conv(f"blocks.{i}.down", ci, co, 1)
            gn(f"blocks.{i}.down_norm", co)
    return items


def _decoder_blocks():
    """(block index, cin, cout) of the decoder's ConvBlocks."""
    out, cin, j = [], ENC[-1], 0
    for i in range(4, -1, -1):
        out.append((j, cin, DEC[i]))
        cin = DEC[i] + (ENC[i - 1] if i > 0 else 0)
        out.append((j + 1, cin, DEC[i]))
        cin, j = DEC[i], j + 2
    return out


def spec(cfg) -> List[Tuple[str, tuple]]:
    """Every weight of the coupled model: (state_dict name, shape)."""
    items = _encoder_spec("depth.encoder.", 3, cfg)
    for j, ci, co in _decoder_blocks():
        items += [(f"depth.decoder.blocks.{j}.conv.weight", (co, ci, 3, 3)),
                  (f"depth.decoder.blocks.{j}.conv.bias", (co,))]
    for i in range(cfg.n_scales):
        items += [(f"depth.decoder.dispconvs.{i}.weight", (1, DEC[i], 3, 3)),
                  (f"depth.decoder.dispconvs.{i}.bias", (1,))]
    items += _encoder_spec("pose_encoder.", 6, cfg)
    cin = ENC[-1]
    if cfg.dcdp_fusion:
        for i in range(2):
            items += [(f"fusion.depth_proj.{i}.weight", (cfg.fusion_channels, ENC[-1], 1, 1)),
                      (f"fusion.depth_proj.{i}.bias", (cfg.fusion_channels,))]
        cin += 2 * cfg.fusion_channels
    for name, ci, co, k in (("squeeze", cin, 256, 1), ("pose_0", 256, 256, 3),
                            ("pose_1", 256, 256, 3), ("pose_2", 256, 6, 1)):
        items += [(f"pose_decoder.{name}.weight", (co, ci, k, k)),
                  (f"pose_decoder.{name}.bias", (co,))]
    return items


# --- the forward -----------------------------------------------------------

def conv(x, w, b, stride: int = 1, pad="same", quant: Quant = None):
    """2-D convolution; ``pad`` is "same" (XLA SAME), "reflect" (one pixel)
    or an int on every side."""
    if quant is not None:
        x, w = quant(x), quant(w)
    k = w.shape[-1]
    if pad == "reflect":
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), w, b)
    if pad == "same":
        ph, pw = _same(x.shape[2], k, stride), _same(x.shape[3], k, stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, w, b, stride)
    return F.conv2d(x, w, b, stride, pad)


def encoder(p: Weights, prefix: str, x: torch.Tensor, cfg, quant: Quant = None):
    """ResNet feature pyramid at /2, /4, /8, /16, /32."""
    norm = cfg.norm == "group"

    def cv(name, x, stride=1):
        w = p[f"{prefix}{name}.weight"]
        if norm:
            return conv(x, w, None, stride, "same", quant)
        return conv(x, w, p[f"{prefix}{name}.bias"], stride, w.shape[-1] // 2, quant)

    def gn(name, x):
        if not norm:
            return x
        return F.group_norm(x, _groups(x.shape[1]), p[f"{prefix}{name}.weight"],
                            p[f"{prefix}{name}.bias"], 1e-6)

    x = F.relu(gn("stem_norm", cv("stem", x, 2)))
    feats = [x]
    x = F.max_pool2d(x, 3, 2, padding=1)
    ends = {sum(STAGES[cfg.num_layers][:i + 1]) - 1 for i in range(4)}
    for i, ci, co, stride in _enc_blocks(cfg.num_layers):
        y = F.relu(gn(f"blocks.{i}.norm1", cv(f"blocks.{i}.conv1", x, stride)))
        y = gn(f"blocks.{i}.norm2", cv(f"blocks.{i}.conv2", y))
        if stride != 1 or ci != co:
            x = gn(f"blocks.{i}.down_norm", cv(f"blocks.{i}.down", x, stride))
        x = F.relu(y + x)
        if i in ends:
            feats.append(x)
    return feats


def decoder(p: Weights, feats, cfg, quant: Quant = None) -> Dict[int, torch.Tensor]:
    """{scale: sigmoid disparity (N, 1, H/2^s, W/2^s)}."""
    pad = "same" if cfg.norm == "group" else "reflect"
    pad = 1 if pad == "same" else pad

    def block(j, x):
        return F.elu(conv(x, p[f"depth.decoder.blocks.{j}.conv.weight"],
                          p[f"depth.decoder.blocks.{j}.conv.bias"], 1, pad, quant))

    out, x = {}, feats[-1]
    for level, i in enumerate(range(4, -1, -1)):
        x = block(2 * level, x)
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if i > 0:
            x = torch.cat([x, feats[i - 1]], dim=1)
        x = block(2 * level + 1, x)
        if i < cfg.n_scales:
            out[i] = torch.sigmoid(conv(x, p[f"depth.decoder.dispconvs.{i}.weight"],
                                        p[f"depth.decoder.dispconvs.{i}.bias"], 1, pad, quant))
    return out


def pose(p: Weights, img_a, img_b, bneck_a, bneck_b, cfg, quant: Quant = None):
    """NCHW frame pair (and their depth bottlenecks) → (axisangle, translation)."""
    x = encoder(p, "pose_encoder.", torch.cat([img_a, img_b], dim=1), cfg, quant)[-1]
    if cfg.dcdp_fusion:
        parts = [x]
        for i, df in enumerate((bneck_a, bneck_b)):
            parts.append(F.relu(conv(df, p[f"fusion.depth_proj.{i}.weight"],
                                     p[f"fusion.depth_proj.{i}.bias"], 1, 0, quant)))
        h = min(t.shape[2] for t in parts)
        w = min(t.shape[3] for t in parts)
        x = torch.cat([t[:, :, :h, :w] for t in parts], dim=1)
    for name, pad in (("squeeze", 0), ("pose_0", 1), ("pose_1", 1)):
        x = F.relu(conv(x, p[f"pose_decoder.{name}.weight"], p[f"pose_decoder.{name}.bias"],
                        1, pad, quant))
    out = conv(x, p["pose_decoder.pose_2.weight"], p["pose_decoder.pose_2.bias"], 1, 0,
               quant).mean(dim=(2, 3))
    return cfg.pose_rotation_scale * out[:, :3], cfg.pose_translation_scale * out[:, 3:]


def depth_net(p: Weights, x, cfg, quant: Quant = None):
    feats = encoder(p, "depth.encoder.", x, cfg, quant)
    return decoder(p, feats, cfg, quant), feats[-1]


def snippet_forward(p: Weights, frames: torch.Tensor, cfg, quant: Quant = None):
    """(B, F, H, W, 3) frames, index 0 the target → (per-frame {scale:
    (B, h, w, 1)} disparities, (B, F − 1, 6) target→source poses)."""
    b, n, h, w, _ = frames.shape
    x = frames.reshape(b * n, h, w, 3).permute(0, 3, 1, 2)
    disp, bneck = depth_net(p, x, cfg, quant)
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


def scaled_disp(disp: torch.Tensor, cfg) -> torch.Tensor:
    """Sigmoid disparity → the scaled disparity 1/depth."""
    lo, hi = 1.0 / cfg.max_depth, 1.0 / cfg.min_depth
    return lo + (hi - lo) * disp


def pair_forward(p: Weights, img_a, img_b, cfg, quant: Quant = None, symmetric=False):
    """(N, 3, H, W) frame pairs → (scaled disparity of a, of b (N, H, W),
    axisangle, translation (N, 3)). ``symmetric`` reads each pair both
    ways and keeps ``0.5·(aa_fwd − aa_rev)`` with the forward translation."""
    disp, bneck = depth_net(p, torch.cat([img_a, img_b]), cfg, quant)
    sd_a, sd_b = scaled_disp(disp[0][:, 0], cfg).chunk(2)
    ba, bb = bneck.chunk(2)
    aa, tr = pose(p, img_a, img_b, ba, bb, cfg, quant)
    if symmetric:
        aa_r, _ = pose(p, img_b, img_a, bb, ba, cfg, quant)
        aa = 0.5 * (aa - aa_r)
    return sd_a, sd_b, aa, tr
