"""Operations and bytes from a cell's shapes: the yardstick of the roofline
and MFU metrics.

``forward_flops`` counts the model's multiply-adds, two operations each, in
every convolution of the reference architecture (``reference/model.py``);
elementwise work, norms and pooling are not counted, so the count is the
same whatever implements the work. Bytes of the hand-written kernels are
each input read once and each output written once, in float32.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.reference.model import DEC, ENC, _decoder_blocks, _enc_blocks

F32 = 4


def _half(x: int) -> int:
    return -(-x // 2)


def _conv(cin: int, cout: int, k: int, h: int, w: int) -> int:
    return 2 * cin * cout * k * k * h * w


def encoder_flops(cin: int, h: int, w: int, cfg) -> tuple:
    """(FLOPs of one image, (h, w) of its /32 bottleneck)."""
    h, w = _half(h), _half(w)
    total = _conv(cin, 64, 7, h, w)
    h, w = _half(h), _half(w)  # the max-pool
    for _, ci, co, stride in _enc_blocks(cfg.num_layers):
        if stride == 2:
            h, w = _half(h), _half(w)
        total += _conv(ci, co, 3, h, w) + _conv(co, co, 3, h, w)
        if stride != 1 or ci != co:
            total += _conv(ci, co, 1, h, w)
    return total, (h, w)


def depth_flops(h: int, w: int, cfg) -> int:
    """One frame's depth pass: encoder, decoder and disparity heads."""
    total, (hb, wb) = encoder_flops(3, h, w, cfg)
    blocks = {j: (ci, co) for j, ci, co in _decoder_blocks()}
    for level, i in enumerate(range(4, -1, -1)):
        total += _conv(*blocks[2 * level], 3, hb, wb)
        hb, wb = 2 * hb, 2 * wb
        total += _conv(*blocks[2 * level + 1], 3, hb, wb)
        if i < cfg.n_scales:
            total += _conv(DEC[i], 1, 3, hb, wb)
    return total


def pose_flops(h: int, w: int, cfg) -> int:
    """One pair's pose pass: the 6-channel encoder, DCDP fusion, decoder."""
    total, (hb, wb) = encoder_flops(6, h, w, cfg)
    cin = ENC[-1]
    if cfg.dcdp_fusion:
        total += 2 * _conv(ENC[-1], cfg.fusion_channels, 1, hb, wb)
        cin += 2 * cfg.fusion_channels
    return (total + _conv(cin, 256, 1, hb, wb) + 2 * _conv(256, 256, 3, hb, wb)
            + _conv(256, 6, 1, hb, wb))


def train_step_flops(cfg) -> int:
    """A training step: forward over B·F frames and B·S pairs, ×3 for the
    backward's two products a forward one."""
    b, n_src = cfg.data.batch_size, len(cfg.data.frame_offsets)
    h, w = cfg.data.height, cfg.data.width
    fwd = b * (n_src + 1) * depth_flops(h, w, cfg.model) + b * n_src * pose_flops(h, w, cfg.model)
    return 3 * fwd


def sample_bytes(n: int, c: int, src_hw, out_hw, with_grad: bool) -> int:
    """Kernel S: the source planes and the two coordinate planes read, the
    sampled planes (and d/dx, d/dy) written."""
    (hs, ws), (ho, wo) = src_hw, out_hw
    return F32 * (n * c * hs * ws + 2 * n * ho * wo + (3 if with_grad else 1) * n * c * ho * wo)


def scatter_bytes(n: int, c: int, src_hw, out_hw) -> int:
    """Kernel T: the cotangent planes and the two coordinate planes read, the
    source cotangent written."""
    (hs, ws), (ho, wo) = src_hw, out_hw
    return F32 * (n * c * ho * wo + 2 * n * ho * wo + n * c * hs * ws)


def geo_grids(cfg) -> List[tuple]:
    """(h, w) of each scale's geometric term."""
    h, w = cfg.data.height, cfg.data.width
    return [(h >> s, w >> s) for s in range(cfg.model.n_scales)]


def train_kernel_bytes(cfg) -> Dict[str, int]:
    """Bytes of one launch of each hand-written kernel a training step makes
    on the default photometric path, keyed by the kernel's name: S on the
    three frame channels (one launch a scale and source), S on the depth
    planes of every geo scale (one launch) and T on the same (one)."""
    b, n_src = cfg.data.batch_size, len(cfg.data.frame_offsets)
    hw = (cfg.data.height, cfg.data.width)
    grids = geo_grids(cfg)
    return {
        "bilinear_sample_kernel": sample_bytes(b, 3, hw, hw, True),
        "bilinear_sample_multi_kernel": sum(sample_bytes(b * n_src, 1, g, g, True)
                                            for g in grids),
        "bilinear_scatter_multi_kernel": sum(scatter_bytes(b * n_src, 1, g, g) for g in grids),
    }
