"""MPViT's depth encoder as MonoViT uses it (Lee et al., arXiv:2112.11010,
``mpvit.py`` of github.com/youngwanLEE/MPViT; ``networks/mpvit.py`` of
github.com/zxcqlf/MonoViT), under the port's U-Net depth decoder.

* Stem: ``Conv2d_BN`` (conv without bias, BatchNorm, Hardswish) 3→C₀/2,
  3×3/s2, then C₀/2→C₀, 3×3/s1: feature 0 at /2. MonoViT moves MPViT's
  second stride into stage 0's first patch embedding, so that the stem's
  map is the first pyramid level.
* Stage i, patch embedding: ``num_path[i]`` ``DWCPatchEmbed`` in a chain
  (path p takes path p − 1's output): a depthwise 3×3 (stride 2 for the
  first), a pointwise 1×1, BatchNorm, Hardswish; C_i in and out.
* Stage i, MHCA: each path's tokens through ``num_layers[i]`` blocks of
  one ``MHCAEncoder``, whose CPE and CRPE its blocks share. A block:
  x ← x + DW3×3(x) (the CPE), x ← x + proj(FA(LN₁(x))), x ← x +
  fc₂(GELU(fc₁(LN₂(x)))), LayerNorm eps 1e-6, fc₁ ``mlp_ratio``× wide,
  exact GELU. FA is CoaT's factorized attention with the CRPE term
  (``kernels.factor_attention``), the CRPE depthwise convolutions of v
  over the heads' channels: 3×3 on the first 2 heads, 5×5 on the next 3,
  7×7 on the last 3.
* Stage i, local path (``InvRes``) on path 0's input: 1×1 ``Conv2d_BN`` +
  Hardswish, depthwise 3×3 without bias, BatchNorm, Hardswish, 1×1
  ``Conv2d_BN``, plus the input. Aggregation: the concatenation [local,
  paths…] through a 1×1 ``Conv2d_BN`` + Hardswish to C_{i+1} (C₃ after
  the last stage).

The pyramid is (C₀ @ /2, C₁ @ /4, C₂ @ /8, C₃ @ /16, C₃ @ /32): at
``mpvit_s`` (64, 128, 216, 288, 288). Convs and linear layers compute in
``dtype`` with float32 parameters; the token residual stream and
LayerNorm's statistics stay float32. BatchNorm (momentum 0.1, eps 1e-5)
normalises by the batch's statistics in training and updates its running
statistics, which ``.eval()`` reads. Module names are MPViT's, less the
blocks' references to their encoder's shared CPE and CRPE. Drop-path is
0. ``PRESETS`` holds the published sizes, keyed by the ``model.depth_net``
value that selects them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from colvo_torch.config import ModelConfig
from colvo_torch.kernels import factor_attention
from colvo_torch.models.depth_decoder import DepthDecoder
from colvo_torch.models.encoder import Conv
from colvo_torch.models.vit import LayerNorm, Linear

# mpvit.py's mpvit_small; heads and the CRPE windows are every MPViT's.
PRESETS: Dict[str, dict] = {
    "mpvit_s": dict(num_path=(2, 3, 3, 3), num_layers=(1, 3, 6, 3),
                    embed_dims=(64, 128, 216, 288), mlp_ratio=4, heads=8),
}
CRPE_WINDOW = {3: 2, 5: 3, 7: 3}  # kernel size: heads


def pyramid_channels(p: dict) -> Tuple[int, ...]:
    """The encoder's five feature widths, /2 to /32."""
    dims = tuple(p["embed_dims"])
    return dims + (dims[-1],)


class Conv2dBN(nn.Module):
    """A conv without bias (torch's padding k // 2), BatchNorm, and
    Hardswish where ``act``."""

    def __init__(self, cin: int, cout: int, k: int, dtype: torch.dtype, stride: int = 1,
                 act: bool = False):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, bias=False, dtype=dtype, padding=k // 2)
        self.bn = nn.BatchNorm2d(cout)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.hardswish(x) if self.act else x


def _depthwise(c: int, k: int, dtype: torch.dtype, bias: bool, stride: int = 1) -> Conv:
    return Conv(c, c, k, stride, bias=bias, dtype=dtype, padding=k // 2, groups=c)


class DWConv2dBN(nn.Module):
    """Depthwise 3×3, pointwise 1×1 (neither with bias), BatchNorm, Hardswish."""

    def __init__(self, c: int, dtype: torch.dtype, stride: int):
        super().__init__()
        self.dwconv = _depthwise(c, 3, dtype, False, stride)
        self.pwconv = Conv(c, c, 1, bias=False, dtype=dtype, padding=0)
        self.bn = nn.BatchNorm2d(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.hardswish(self.bn(self.pwconv(self.dwconv(x))))


class DWCPatchEmbed(nn.Module):
    def __init__(self, c: int, dtype: torch.dtype, stride: int):
        super().__init__()
        self.patch_conv = DWConv2dBN(c, dtype, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.patch_conv(x)


class PatchEmbedStage(nn.Module):
    """The stage's paths' inputs: patch embeddings in a chain, the first
    with stride 2."""

    def __init__(self, c: int, num_path: int, dtype: torch.dtype):
        super().__init__()
        self.patch_embeds = nn.ModuleList(DWCPatchEmbed(c, dtype, 2 if i == 0 else 1)
                                          for i in range(num_path))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        out = []
        for embed in self.patch_embeds:
            x = embed(x)
            out.append(x)
        return out


def _tokens_as_image(t: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, H·W, C) tokens → a (B, C, H, W) view (channels last)."""
    return t.view(t.shape[0], size[0], size[1], t.shape[2]).permute(0, 3, 1, 2)


def _image_as_tokens(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


class ConvPosEnc(nn.Module):
    """CPE: the tokens plus a depthwise 3×3 (with bias) of them as an image."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.proj = _depthwise(dim, 3, dtype, True)

    def forward(self, t: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
        return t + _image_as_tokens(self.proj(_tokens_as_image(t, size)))


class ConvRelPosEnc(nn.Module):
    """CRPE's convolutions: v's channels as an image, split by heads as
    ``CRPE_WINDOW`` says, each group through a depthwise conv (with bias)
    of its window."""

    def __init__(self, head_dim: int, dtype: torch.dtype):
        super().__init__()
        self.splits = [n * head_dim for n in CRPE_WINDOW.values()]
        self.conv_list = nn.ModuleList(_depthwise(c, k, dtype, True)
                                       for k, c in zip(CRPE_WINDOW, self.splits))

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        parts = torch.split(v, self.splits, dim=1)
        return torch.cat([conv(x) for conv, x in zip(self.conv_list, parts)], dim=1)


class FactorAttConvRelPosEnc(nn.Module):
    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)

    def forward(self, x: torch.Tensor, size: Tuple[int, int], crpe: ConvRelPosEnc
                ) -> torch.Tensor:
        c = x.shape[2]
        qkv = self.qkv(x)  # (B, N, 3·C): (3, heads, d) a token
        cv = _image_as_tokens(crpe(_tokens_as_image(qkv, size)[:, 2 * c:]))
        return self.proj(factor_attention(qkv, cv, self.heads))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype)
        self.fc2 = Linear(hidden, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class MHCABlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int, dtype: torch.dtype):
        super().__init__()
        self.factoratt_crpe = FactorAttConvRelPosEnc(dim, heads, dtype)
        self.mlp = Mlp(dim, dim * mlp_ratio, dtype)
        self.norm1 = LayerNorm(dim, dtype)
        self.norm2 = LayerNorm(dim, dtype)

    def forward(self, t: torch.Tensor, size: Tuple[int, int], cpe: ConvPosEnc,
                crpe: ConvRelPosEnc) -> torch.Tensor:
        t = cpe(t, size)
        t = t + self.factoratt_crpe(self.norm1(t), size, crpe).float()
        return t + self.mlp(self.norm2(t)).float()


class MHCAEncoder(nn.Module):
    """One path: its blocks over the float32 token stream, sharing the
    encoder's CPE and CRPE; (B, C, H, W) in, (B, C, H, W) in ``dtype`` out."""

    def __init__(self, dim: int, num_layers: int, heads: int, mlp_ratio: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.cpe = ConvPosEnc(dim, dtype)
        self.crpe = ConvRelPosEnc(dim // heads, dtype)
        self.MHCA_layers = nn.ModuleList(MHCABlock(dim, heads, mlp_ratio, dtype)
                                         for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = (x.shape[2], x.shape[3])
        t = _image_as_tokens(x).float()
        for layer in self.MHCA_layers:
            t = layer(t, size, self.cpe, self.crpe)
        return _tokens_as_image(t.to(self.dtype), size)


class InvRes(nn.Module):
    """The local path: 1×1 Conv2d_BN + Hardswish, depthwise 3×3, BatchNorm,
    Hardswish, 1×1 Conv2d_BN, plus the input."""

    def __init__(self, c: int, dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv2dBN(c, c, 1, dtype, act=True)
        self.dwconv = _depthwise(c, 3, dtype, False)
        self.norm = nn.BatchNorm2d(c)
        self.conv2 = Conv2dBN(c, c, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.hardswish(self.norm(self.dwconv(self.conv1(x))))
        return x + self.conv2(y)


class MHCAStage(nn.Module):
    def __init__(self, dim: int, out_dim: int, num_layers: int, heads: int, mlp_ratio: int,
                 num_path: int, dtype: torch.dtype):
        super().__init__()
        self.mhca_blks = nn.ModuleList(MHCAEncoder(dim, num_layers, heads, mlp_ratio, dtype)
                                       for _ in range(num_path))
        self.InvRes = InvRes(dim, dtype)
        self.aggregate = Conv2dBN(dim * (num_path + 1), out_dim, 1, dtype, act=True)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        outs = [self.InvRes(inputs[0])]
        outs += [enc(x) for x, enc in zip(inputs, self.mhca_blks)]
        return self.aggregate(torch.cat(outs, dim=1))


class MPViT(nn.Module):
    """(B, 3, H, W) frames → the five-level pyramid, /2 to /32."""

    def __init__(self, p: dict, dtype: torch.dtype):
        super().__init__()
        dims, n = tuple(p["embed_dims"]), len(p["embed_dims"])
        self.dtype = dtype
        self.stem = nn.Sequential(Conv2dBN(3, dims[0] // 2, 3, dtype, stride=2, act=True),
                                  Conv2dBN(dims[0] // 2, dims[0], 3, dtype, act=True))
        self.patch_embed_stages = nn.ModuleList(
            PatchEmbedStage(dims[i], p["num_path"][i], dtype) for i in range(n))
        self.mhca_stages = nn.ModuleList(
            MHCAStage(dims[i], dims[min(i + 1, n - 1)], p["num_layers"][i], p["heads"],
                      p["mlp_ratio"], p["num_path"][i], dtype) for i in range(n))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x.to(self.dtype).contiguous(memory_format=torch.channels_last))
        feats = [x]
        for embed, stage in zip(self.patch_embed_stages, self.mhca_stages):
            x = stage(embed(x))
            feats.append(x)
        return feats


class MPViTDepthNet(nn.Module):
    """Single-frame depth on MPViT: NCHW image in [0, 1] → ({scale: disp
    (B, 1, h, w)}, the /32 feature, which DCDP fuses into the pose net)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        if cfg.remat:
            raise ValueError(f"model.remat does not cover model.depth_net={cfg.depth_net!r}")
        p = PRESETS[cfg.depth_net]
        self.channels = pyramid_channels(p)
        self.encoder = MPViT(p, dtype)
        self.decoder = DepthDecoder(cfg.n_scales, dtype, "same", channels=self.channels)

    def forward(self, img: torch.Tensor) -> Tuple[Dict[int, torch.Tensor], torch.Tensor]:
        feats = self.encoder(img)
        return self.decoder(feats), feats[-1]
