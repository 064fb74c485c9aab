"""DINOv2 ViT encoder of Depth Anything V2 (``depth_anything_v2/dinov2.py``
of github.com/DepthAnything/Depth-Anything-V2; Oquab et al.,
arXiv:2304.07193).

A 14×14/s14 patch conv, a cls token (no register tokens) and a 37×37+1
position table, interpolated bicubically to the patch grid as DINOv2's
``interpolate_pos_encoding`` does (with its 0.1 offset, and the table
itself at a 37×37 grid); then pre-norm blocks: LayerNorm (eps 1e-6) →
multi-head attention (qkv and proj with biases) → LayerScale, added, and
LayerNorm → MLP (4× width, exact GELU) → LayerScale, added. The encoder
returns the outputs of the ``taps`` blocks, each through the final
LayerNorm, without the cls token (``get_intermediate_layers(norm=True)``).

Linear layers and convs compute in ``dtype`` (bf16 on the card) with
float32 parameters; the residual stream and LayerNorm's statistics stay
float32. Module names are DA-V2's. With ``remat`` each block is recomputed
in the backward, as a ResNet ``BasicBlock`` is.

``PRESETS`` holds DA-V2's published sizes (``run.py``'s
``model_configs``, ``dpt.py``'s ``intermediate_layer_idx``), keyed by the
``model.depth_net`` value that selects them.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from colvo_torch.kernels import attention
from colvo_torch.models.encoder import Conv, remat_call

PATCH = 14
POS_GRID = 37  # DINOv2's 518-pixel training grid
POS_OFFSET = 0.1  # DINOv2's interpolate_offset

PRESETS: Dict[str, dict] = {
    "dpt_vits14": dict(dim=384, depth=12, heads=6, taps=(2, 5, 8, 11), features=64,
                       out_channels=(48, 96, 192, 384)),
    "dpt_vitb14": dict(dim=768, depth=12, heads=12, taps=(2, 5, 8, 11), features=128,
                       out_channels=(96, 192, 384, 768)),
    "dpt_vitl14": dict(dim=1024, depth=24, heads=16, taps=(4, 11, 17, 23), features=256,
                       out_channels=(256, 512, 1024, 1024)),
}


def preset(depth_net: str) -> dict:
    """The sizes ``model.depth_net`` names."""
    if depth_net not in PRESETS:
        raise ValueError(f"model.depth_net must be 'resnet' or one of {sorted(PRESETS)}, "
                         f"not {depth_net!r}")
    return PRESETS[depth_net]


class Linear(nn.Module):
    """A linear layer computing in ``dtype``; weights trunc-normal of std
    0.02 (timm's ``trunc_normal_``), biases 0."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, 0.02, -2.0, 2.0, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class LayerNorm(nn.LayerNorm):
    """eps 1e-6, statistics in float32, output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__(dim, eps=1e-6)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.dtype)


class LayerScale(nn.Module):
    """A learned per-channel scale of a residual branch (init 1.0, as DA-V2
    builds DINOv2), whose float32 product joins the residual stream."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() * self.gamma


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.proj = Linear(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        out = attention(qkv[0], qkv[1], qkv[2])
        return self.proj(out.transpose(1, 2).reshape(b, n, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(dim, 4 * dim, dtype)
        self.fc2 = Linear(4 * dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """One pre-norm transformer block on the float32 residual stream."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = Attention(dim, heads, dtype)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, dtype)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.proj = Conv(3, dim, PATCH, PATCH, bias=True, dtype=dtype, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, 14·gh, 14·gw) → (B, gh·gw, dim) tokens, row-major."""
        return self.proj(x).flatten(2).transpose(1, 2)


class ViTEncoder(nn.Module):
    """ImageNet-normalised (B, 3, 14·gh, 14·gw) → the ``taps`` blocks'
    normalised patch tokens, each (B, gh·gw, dim) in ``dtype``."""

    def __init__(self, dim: int, depth: int, heads: int, taps, dtype: torch.dtype,
                 remat: bool = False):
        super().__init__()
        self.taps = tuple(taps)
        self.remat = remat
        self.patch_embed = PatchEmbed(dim, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, POS_GRID * POS_GRID + 1, dim))
        self.blocks = nn.ModuleList(Block(dim, heads, dtype) for _ in range(depth))
        self.norm = LayerNorm(dim, dtype)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """DINOv2's init of the two tables: positions trunc-normal of std
        0.02, the cls token normal of std 1e-6."""
        with torch.no_grad():
            nn.init.trunc_normal_(self.pos_embed, 0.0, 0.02, -2.0, 2.0, generator=generator)
            nn.init.normal_(self.cls_token, 0.0, 1e-6, generator=generator)

    def pos_table(self, gh: int, gw: int) -> torch.Tensor:
        """The position table at a gh × gw patch grid, float32 (1, 1+gh·gw, dim)."""
        if gh == gw == POS_GRID:
            return self.pos_embed
        dim = self.pos_embed.shape[-1]
        grid = self.pos_embed[:, 1:].reshape(1, POS_GRID, POS_GRID, dim).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, scale_factor=((gh + POS_OFFSET) / POS_GRID,
                                                 (gw + POS_OFFSET) / POS_GRID), mode="bicubic")
        return torch.cat([self.pos_embed[:, :1], grid.flatten(2).transpose(1, 2)], dim=1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        gh, gw = x.shape[2] // PATCH, x.shape[3] // PATCH
        t = self.patch_embed(x).float()
        t = torch.cat([self.cls_token.expand(t.shape[0], -1, -1), t], dim=1)
        t = t + self.pos_table(gh, gw)
        out = []
        for i, block in enumerate(self.blocks):
            t = remat_call(block, t) if self.remat else block(t)
            if i in self.taps:
                out.append(self.norm(t)[:, 1:])
        return out


def grid_size(size: int) -> int:
    """The patch count along a side: the frame is resized to the nearest
    multiple of 14 (ties up), at least one patch."""
    return max(1, math.floor(size / PATCH + 0.5))
