"""The DPT cell's yardstick: ``flops_dpt``'s forward counts against
``torch.utils.flop_counter`` over the reference network, its kernel
kinds on the names the card's libraries give, and the six per-layer
readers on a synthetic trace (nothing from a program that reports no
attention calls). The reference and the driver load no JAX and, the
reference, nothing of the program."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from colvo_torch.config import ColvoConfig
from portbench import flops, flops_dpt, harness
from portbench.reference import dpt
from portbench.trace import Trace

SMALL = dict(dim=64, depth=4, heads=4, taps=(0, 1, 2, 3), features=16,
             out_channels=(8, 16, 32, 32))
READERS = ["train_mfu.dpt", "device_ms.dpt", "attention_ms.dpt", "vit_gemm_ms.dpt",
           "conv_ms.dpt", "attention_roofline.dpt"]


@pytest.fixture(autouse=True)
def tiny_preset(monkeypatch):
    monkeypatch.setitem(dpt.PRESETS, "dpt_tiny14", SMALL)


def _cfg(h, w):
    cfg = ColvoConfig()
    m = cfg.model
    m.depth_net, m.n_scales, m.dcdp_fusion = "dpt_tiny14", 1, False
    cfg.data.height, cfg.data.width, cfg.data.batch_size = h, w, 2
    return cfg


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("hw", [(56, 70), (64, 96)])
def test_flops_match_the_flop_counter(hw):
    """One frame's depth pass and a step's forward, counted exactly; the
    step is three forwards but attention's, which FlashAttention-2's
    backward makes 3.5."""
    cfg = _cfg(*hw)
    m = cfg.model
    w = {k: v.to("meta") for k, v in dpt.weights(m, 1, "cpu").items()}
    rest, attn = flops_dpt.depth_flops(*hw, m)
    assert _counted(lambda: dpt.depth_net(w, torch.empty(1, 3, *hw, device="meta"), m)) \
        == rest + attn
    frames = torch.empty(2, 3, *hw, 3, device="meta")
    fwd = _counted(lambda: dpt.snippet_forward(w, frames, m))
    assert fwd == 6 * (rest + attn) + 4 * flops.pose_flops(*hw, m)
    assert flops_dpt.train_step_flops(cfg) == 3 * fwd + 6 * attn // 2
    assert flops_dpt.attention_call_flops(cfg) == (6 * attn // SMALL["depth"],
                                                   6 * attn * 10 // 4 // SMALL["depth"])


@pytest.mark.parametrize("name,kind", [
    ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128>>", "attention"),
    ("flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel", "attention"),
    ("fmha_cutlassF_bf16_aligned_64x64_rf_sm80", "attention"),
    ("cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_3", "attention"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "conv"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>", "conv"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32", "conv"),
    ("nvjet_tst_128x240_64x4_2x1_v_bz_coopA_NNT", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>", None),
])
def test_kernel_kinds(name, kind):
    assert flops_dpt.kernel_kind(name) == kind


def _run(attn_calls):
    names = ["flash_fwd_kernel", "flash_bwd_dq_dk_dv_loop_kernel", "nvjet_tst_128x240",
             "sm90_xmma_fprop_implicit_gemm_bf16", "elementwise_kernel"]
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": 100.0 * i, "dur": 50.0}
              for i, n in enumerate(names * 2)]
    cfg = _cfg(224, 280)
    cfg.model.depth_net, cfg.data.batch_size = "dpt_vitl14", 12
    return SimpleNamespace(trace=Trace(events, 2e-3), peaks={"bf16_flops_s": 989e12},
                           layer={"step_ms": 150.0, "trace_steps": 2, "cfg": cfg,
                                  "attn_calls": attn_calls})


def test_readers_on_a_synthetic_trace():
    run = _run(24)
    got = {name: harness.reader(name).read(run) for name in READERS}
    assert got["device_ms.dpt"] == pytest.approx(0.25)
    assert got["attention_ms.dpt"] == pytest.approx(0.1)
    assert got["vit_gemm_ms.dpt"] == got["conv_ms.dpt"] == pytest.approx(0.05)
    fwd, bwd = flops_dpt.attention_call_flops(run.layer["cfg"])
    assert got["attention_roofline.dpt"] == pytest.approx(100 * 24 * (fwd + bwd) / 989e12 / 1e-4)
    step = flops_dpt.train_step_flops(run.layer["cfg"])
    assert got["train_mfu.dpt"] == pytest.approx(100 * step / 0.15 / 989e12)


@pytest.mark.parametrize("calls", [None, 0])
def test_roofline_reads_nothing_without_attention_calls(calls):
    """A program without the ``attn/fwd`` counter (the parent's) gives 0
    calls, and the reader nothing."""
    assert harness.reader("attention_roofline.dpt").read(_run(calls)) is None


def test_reference_and_driver_load_no_jax():
    probe = ("import json, sys\nsys.modules.setdefault('torch.utils.tensorboard', None)\n"
             "import portbench.reference.dpt, portbench.flops_dpt\n"
             "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
             "import portbench.kinds.train_dpt\n"
             "print(json.dumps([ref, sorted({m.split('.')[0] for m in sys.modules})]))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=harness.ROOT, check=True)
    ref, driver = (set(x) for x in json.loads(out.stdout.strip().splitlines()[-1]))
    assert not ref & (set(harness.FORBIDDEN) | {"colvo_torch"})
    assert not driver & set(harness.FORBIDDEN)
