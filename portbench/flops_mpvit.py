"""Operations of a training step on an MPViT depth net
(``reference/mpvit.py``), the yardstick of ``train_mfu.mpvit``; the bytes
kernel FA moves, the yardstick of ``fa_roofline.mpvit``; and the kernel
names of the cell's per-layer device metrics.

As ``flops.py`` counts: two operations a multiply-add of every GEMM and
convolution (a depthwise one: k² a channel and pixel), nothing for
elementwise work, norms, softmax or pooling. Factorized attention is its
two products, softmax(k)ᵀ·v and q·KV, N·C·d multiply-adds each (d the
head width), its CRPE term the three depthwise convolutions. A backward
is twice its forward (FA's: four such products). The pose net's count is
``flops.pose_flops`` with the fusion's input at the encoder's /32 width.
"""

from __future__ import annotations

from typing import Optional, Tuple

from portbench import flops
from portbench.reference.model import DEC, ENC
from portbench.reference.mpvit import CRPE_WINDOW, PRESETS, channels

_conv = flops._conv
BF16 = 2
# Bytes of (F, N, C) a call moves once, in bfloat16: the forward reads q,
# k, v and cv and writes out; the backward reads q, k, v, g and cv and
# writes dq, dk, dv and dcv.
FA_FWD_BYTES, FA_BWD_BYTES = 5 * BF16, 9 * BF16


def _dw(c: int, k: int, h: int, w: int) -> int:
    return _conv(1, c, k, h, w)


def stage_sizes(h: int, w: int, cfg):
    """(C, tokens' h, w, paths, layers, out width) of each stage."""
    p = PRESETS[cfg.depth_net]
    dims, out = p["embed_dims"], []
    h, w = flops._half(h), flops._half(w)  # the stem's stride
    for i, c in enumerate(dims):
        h, w = flops._half(h), flops._half(w)
        out.append((c, h, w, p["num_path"][i], p["num_layers"][i], dims[min(i + 1, len(dims) - 1)]))
    return out


def block_flops(c: int, h: int, w: int, cfg) -> Tuple[int, int]:
    """One MHCA block over an h × w token map: (everything but the two
    attention products, the two products)."""
    p = PRESETS[cfg.depth_net]
    n, d, r = h * w, c // p["heads"], p["mlp_ratio"]
    crpe = sum(_dw(heads * d, k, h, w) for k, heads in CRPE_WINDOW)
    rest = _dw(c, 3, h, w) + crpe + 2 * n * c * (3 * c + c + 2 * r * c)
    return rest, 2 * 2 * n * c * d


def stage_flops(c: int, h: int, w: int, paths: int, layers: int, out: int, cfg) -> int:
    """One frame through a stage, its patch embeddings included."""
    embed = paths * (_dw(c, 3, h, w) + _conv(c, c, 1, h, w))
    invres = 2 * _conv(c, c, 1, h, w) + _dw(c, 3, h, w)
    return (embed + invres + paths * layers * sum(block_flops(c, h, w, cfg))
            + _conv(c * (paths + 1), out, 1, h, w))


def encoder_flops(h: int, w: int, cfg) -> int:
    dims = PRESETS[cfg.depth_net]["embed_dims"]
    h2, w2 = flops._half(h), flops._half(w)
    total = _conv(3, dims[0] // 2, 3, h2, w2) + _conv(dims[0] // 2, dims[0], 3, h2, w2)
    return total + sum(stage_flops(*s, cfg) for s in stage_sizes(h, w, cfg))


def depth_flops(h: int, w: int, cfg) -> int:
    """One frame's depth pass: encoder, U-Net decoder and disparity heads."""
    enc = channels(PRESETS[cfg.depth_net])
    _, hb, wb, *_ = stage_sizes(h, w, cfg)[-1]
    total, cin = encoder_flops(h, w, cfg), enc[-1]
    for i in range(4, -1, -1):
        total += _conv(cin, DEC[i], 3, hb, wb)
        hb, wb = 2 * hb, 2 * wb
        total += _conv(DEC[i] + (enc[i - 1] if i > 0 else 0), DEC[i], 3, hb, wb)
        if i < cfg.n_scales:
            total += _conv(DEC[i], 1, 3, hb, wb)
        cin = DEC[i]
    return total


def pose_flops(h: int, w: int, cfg) -> int:
    """One pair's pose pass, DCDP's projections taking the /32 feature."""
    total = flops.pose_flops(h, w, cfg)
    if cfg.dcdp_fusion:
        _, (hb, wb) = flops.encoder_flops(6, h, w, cfg)
        width = channels(PRESETS[cfg.depth_net])[-1]
        total += 2 * (_conv(width, cfg.fusion_channels, 1, hb, wb)
                      - _conv(ENC[-1], cfg.fusion_channels, 1, hb, wb))
    return total


def train_step_flops(cfg) -> int:
    """A training step: forward over B·F frames and B·S pairs, ×3 for the
    backward's two products a forward one."""
    b, n_src = cfg.data.batch_size, len(cfg.data.frame_offsets)
    h, w = cfg.data.height, cfg.data.width
    fwd = (b * (n_src + 1) * depth_flops(h, w, cfg.model)
           + b * n_src * pose_flops(h, w, cfg.model))
    return 3 * fwd


def fa_calls(cfg) -> int:
    """FA's forward calls a step: one a path and layer."""
    return sum(paths * layers for *_, paths, layers, _ in stage_sizes(1, 1, cfg.model))


def fa_step_bytes(cfg) -> int:
    """The bytes FA moves once a step, forward and backward, in bfloat16."""
    frames = cfg.data.batch_size * (len(cfg.data.frame_offsets) + 1)
    sizes = stage_sizes(cfg.data.height, cfg.data.width, cfg.model)
    elems = sum(paths * layers * frames * h * w * c for c, h, w, paths, layers, _ in sizes)
    return elems * (FA_FWD_BYTES + FA_BWD_BYTES)


FA = ("fa_fwd_", "fa_bwd_")
# cuDNN names its depthwise kernels by one channel and one filter a group
# (``conv2d_c1_k1_nhwc``, ``dgrad2d_c1_k1_nhwc_specialized``,
# ``wgrad2d_c1_k1_nhwc``); ``wgrad2d_shmem_tiling`` is its depthwise weight
# gradient's tiled variant; PyTorch's own are ``conv_depthwise2d_*``. Its
# ``*_grouped_direct_kernel`` is left out: it also runs dense convolutions
# (groups = 1) of the pose net and the decoder.
DWCONV = ("depthwise", "_c1_k1", "wgrad2d_shmem_tiling")


def kernel_kind(name: str) -> Optional[str]:
    """"fa" (kernel FA's six kernels) or "dwconv" (the depthwise
    convolutions' kernels, forward and backward, of cuDNN and of PyTorch)
    by the kernel's name; else None."""
    low = name.lower()
    for kind, keys in (("fa", FA), ("dwconv", DWCONV)):
        if any(k in low for k in keys):
            return kind
    return None
