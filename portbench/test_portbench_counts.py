"""The yardstick's counts: model FLOPs against ``torch.utils.flop_counter``
over the reference network, and the bytes of kernels S and T against the
tensors' own sizes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from colvo_torch.config import ColvoConfig
from portbench import flops, weights
from portbench.reference import model as ref


def _cfg(norm: str, fusion: bool) -> ColvoConfig:
    cfg = ColvoConfig()
    cfg.model.norm, cfg.model.dcdp_fusion = norm, fusion
    cfg.data.height, cfg.data.width, cfg.data.batch_size = 64, 96, 2
    return cfg


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("norm,fusion", [("group", True), ("none", False)])
def test_model_flops_match_the_flop_counter(norm, fusion):
    cfg = _cfg(norm, fusion)
    w = {k: v.to("meta") for k, v in weights.make(cfg.model, 1, "cpu").items()}
    h, wd = cfg.data.height, cfg.data.width
    img = torch.empty(1, 3, h, wd, device="meta")
    assert _counted(lambda: ref.depth_net(w, img, cfg.model)) == flops.depth_flops(h, wd, cfg.model)
    bn = torch.empty(1, 512, h // 32, wd // 32, device="meta")
    assert (_counted(lambda: ref.pose(w, img, img, bn, bn, cfg.model))
            == flops.pose_flops(h, wd, cfg.model))
    frames = torch.empty(2, 3, h, wd, 3, device="meta")
    step = flops.train_step_flops(cfg)
    assert 3 * _counted(lambda: ref.snippet_forward(w, frames, cfg.model)) == step


def test_kernel_bytes_match_the_tensors():
    cfg = _cfg("group", True)
    b, s, h, w = 2, 2, 64, 96
    planes = torch.empty(b, 3, h, w)
    coords = torch.empty(b, h, w)
    got = flops.train_kernel_bytes(cfg)
    assert got["bilinear_sample_kernel"] == (planes.nbytes + 2 * coords.nbytes
                                             + 3 * planes.nbytes)
    geo = [(torch.empty(b * s, 1, gh, gw), torch.empty(b * s, gh, gw))
           for gh, gw in flops.geo_grids(cfg)]
    assert got["bilinear_sample_multi_kernel"] == sum(4 * p.nbytes + 2 * c.nbytes for p, c in geo)
    assert got["bilinear_scatter_multi_kernel"] == sum(2 * p.nbytes + 2 * c.nbytes
                                                       for p, c in geo)
