"""Operations of a training step on a DPT depth net (``reference/dpt.py``),
the yardstick of ``train_mfu.dpt`` and ``attention_roofline.dpt``, and the
kernel names of its per-layer device metrics.

As ``flops.py`` counts: two operations a multiply-add of every GEMM and
convolution (the transposed ones: each input pixel times its k×k
outputs), nothing for elementwise work, norms, interpolation or softmax.
Attention is counted as FlashAttention-2 computes it: q·kᵀ and p·v,
4·N²·d a forward (d the width over all heads), and five such products,
10·N²·d, a backward; every other product's backward is twice its
forward. The pose net's count is ``flops.pose_flops``.
"""

from __future__ import annotations

from typing import Optional, Tuple

from portbench import flops
from portbench.reference.dpt import PATCH, PRESETS, grid_size
from portbench.trace import BUCKETS

_conv = flops._conv


def vit_flops(h: int, w: int, cfg) -> Tuple[int, int]:
    """One frame through the ViT: (GEMM and patch-conv FLOPs, attention's
    forward FLOPs)."""
    p = PRESETS[cfg.depth_net]
    gh, gw = grid_size(h), grid_size(w)
    n, d = gh * gw + 1, p["dim"]
    patch = _conv(3, d, PATCH, gh, gw)
    per_block = 2 * n * d * (3 * d + d + 4 * d + 4 * d)  # qkv, proj, fc1, fc2
    return patch + p["depth"] * per_block, p["depth"] * 4 * n * n * d


def head_flops(h: int, w: int, cfg) -> int:
    """One frame through the DPT head."""
    p = PRESETS[cfg.depth_net]
    gh, gw = grid_size(h), grid_size(w)
    f, c, d = p["features"], p["out_channels"], p["dim"]
    total = sum(_conv(d, ci, 1, gh, gw) for ci in c)
    total += _conv(c[0], c[0], 4, gh, gw) + _conv(c[1], c[1], 2, gh, gw)  # transposed
    g4 = (-(-gh // 2), -(-gw // 2))
    total += _conv(c[3], c[3], 3, *g4)
    sizes = [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw), g4]
    total += sum(_conv(ci, f, 3, *hw) for ci, hw in zip(c, sizes))
    rcu = 2 * _conv(f, f, 3, 1, 1)  # a residual unit a pixel
    outs = [(8 * gh, 8 * gw)] + sizes[:3]  # each fusion block's output grid
    for i, (hw, out) in enumerate(zip(sizes, outs)):
        units = 2 if i < 3 else 1
        total += units * rcu * hw[0] * hw[1] + _conv(f, f, 1, *out)
    total += _conv(f, f // 2, 3, *outs[0])
    return total + _conv(f // 2, 32, 3, h, w) + _conv(32, 1, 1, h, w)


def depth_flops(h: int, w: int, cfg) -> Tuple[int, int]:
    """One frame's depth pass: (FLOPs but attention's, attention's forward)."""
    gemm, attn = vit_flops(h, w, cfg)
    return gemm + head_flops(h, w, cfg), attn


def attention_call_flops(cfg) -> Tuple[int, int]:
    """(forward, backward) FLOPs of one attention call of a training step: a
    block over the step's B·F frames."""
    p = PRESETS[cfg.model.depth_net]
    n = grid_size(cfg.data.height) * grid_size(cfg.data.width) + 1
    frames = cfg.data.batch_size * (len(cfg.data.frame_offsets) + 1)
    fwd = frames * 4 * n * n * p["dim"]
    return fwd, fwd * 10 // 4


def train_step_flops(cfg) -> int:
    """A training step: forward over B·F frames and B·S pairs, ×3 for the
    backward's two products a forward one, and attention at 4 + 10 N²·d."""
    b, n_src = cfg.data.batch_size, len(cfg.data.frame_offsets)
    h, w = cfg.data.height, cfg.data.width
    rest, attn = depth_flops(h, w, cfg.model)
    rest = b * (n_src + 1) * rest + b * n_src * flops.pose_flops(h, w, cfg.model)
    return 3 * rest + b * (n_src + 1) * attn * 14 // 4


ATTENTION = ("flash", "fmha", "sdpa", "attention")
CONV = dict(BUCKETS)["conv"]
GEMM = ("gemm", "xmma", "cutlass", "nvjet")


def kernel_kind(name: str) -> Optional[str]:
    """"attention", "conv" or "gemm" by the kernel's name, first match
    winning in that order (cuDNN's attention kernels name ``sdpa`` and
    ``fprop`` both; its convolutions ``xmma`` and ``fprop``); else None."""
    low = name.lower()
    for kind, keys in (("attention", ATTENTION), ("conv", CONV), ("gemm", GEMM)):
        if any(k in low for k in keys):
            return kind
    return None

