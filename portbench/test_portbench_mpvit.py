"""The MPViT cell's yardstick and the two new drivers: ``flops_mpvit``'s
forward counts against ``torch.utils.flop_counter`` over the reference
network and against a hand count of one stage, the kernel kinds, the five
per-layer readers on a synthetic trace (nothing from a program that
reports no FA calls); both drivers end to end on the CPU at toy sizes
(``train_mpvit`` at a small preset put into both preset tables); the I420
planes and their decoding against the program's; and the reference and
drivers loading no JAX."""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from colvo_torch.config import ColvoConfig
from portbench import flops_mpvit, harness, testing
from portbench.kinds import vo_i420
from portbench.reference import mpvit
from portbench.trace import Trace

TINY = "mpvit_tiny"
SMALL = dict(num_path=(2, 3, 3, 3), num_layers=(1, 1, 2, 1), embed_dims=(16, 24, 32, 40),
             mlp_ratio=4, heads=8)
READERS = ["device_ms.mpvit", "train_mfu.mpvit", "fa_ms.mpvit", "fa_roofline.mpvit",
           "dwconv_ms.mpvit"]


@pytest.fixture
def tiny_preset(monkeypatch):
    from colvo_torch.models import mpvit as program

    monkeypatch.setitem(mpvit.PRESETS, TINY, SMALL)
    monkeypatch.setitem(program.PRESETS, TINY, SMALL)


def _cfg(net=TINY, h=64, w=96, b=2):
    cfg = ColvoConfig()
    cfg.model.depth_net = net
    cfg.data.height, cfg.data.width, cfg.data.batch_size = h, w, b
    return cfg


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_flops_match_the_flop_counter(tiny_preset):
    """One frame's depth pass and a step's forward, counted exactly."""
    cfg = _cfg()
    m = cfg.model
    w = {k: v.to("meta") for k, v in mpvit.weights(m, 1, "cpu").items()}
    assert _counted(lambda: mpvit.depth_net(w, torch.empty(1, 3, 64, 96, device="meta"), m)) \
        == flops_mpvit.depth_flops(64, 96, m)
    frames = torch.empty(2, 3, 64, 96, 3, device="meta")
    fwd = _counted(lambda: mpvit.snippet_forward(w, frames, m))
    assert 3 * fwd == flops_mpvit.train_step_flops(cfg)


def test_one_stage_by_hand():
    """MPViT-Small's last stage at 256×320 (8×10 tokens, C 288, 3 paths of
    3 layers, d 36), multiply-adds counted by hand."""
    n, c, d, hw = 80, 288, 36, 80
    embed = 3 * (c * 9 * hw + c * c * hw)
    invres = 2 * c * c * hw + c * 9 * hw
    cpe, crpe = c * 9 * n, (2 * 9 + 3 * 25 + 3 * 49) * d * n
    gemms = n * c * 3 * c + n * c * c + 2 * n * c * 4 * c
    block = cpe + crpe + gemms + 2 * n * c * d
    macs = embed + invres + 9 * block + 4 * c * c * hw
    cfg = _cfg("mpvit_s", 256, 320, 12)
    assert flops_mpvit.stage_sizes(256, 320, cfg.model)[3] == (288, 8, 10, 3, 3, 288)
    assert flops_mpvit.stage_flops(288, 8, 10, 3, 3, 288, cfg.model) == 2 * macs
    assert flops_mpvit.fa_calls(cfg) == 38
    elems = 36 * (2 * 5120 * 64 + 9 * 1280 * 128 + 18 * 320 * 216 + 9 * 80 * 288)
    assert flops_mpvit.fa_step_bytes(cfg) == elems * (10 + 18)


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::fa_fwd_reduce<__nv_bfloat16>(FaArgs)", "fa"),
    ("void (anonymous namespace)::fa_bwd_apply<__nv_bfloat16>(FaArgs)", "fa"),
    ("void cudnn::cnn::conv2d_grouped_direct_kernel<false, true, false>", None),
    ("void cudnn::cnn::wgrad2d_grouped_direct_kernel<false, true>", None),
    ("void at::native::conv_depthwise2d_backward_kernel<__nv_bfloat16>", "dwconv"),
    ("conv2d_c1_k1_nhwc_specialized", "dwconv"),
    ("dgrad2d_c1_k1_nhwc_specialized", "dwconv"),
    ("wgrad2d_c1_k1_nhwc_reduce", "dwconv"),
    ("wgrad2d_shmem_tiling", "dwconv"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", None),
    ("nvjet_tst_128x240_64x4_2x1_v_bz_coopA_NNT", None),
])
def test_kernel_kinds(name, kind):
    assert flops_mpvit.kernel_kind(name) == kind


def _run(fa_calls):
    names = ["void fa_fwd_reduce<__nv_bfloat16>", "void fa_bwd_apply<__nv_bfloat16>",
             "conv2d_c1_k1_nhwc_specialized", "nvjet_tst_128x240", "wgrad2d_grouped_direct_kernel"]
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": 100.0 * i, "dur": 50.0}
              for i, n in enumerate(names * 2)]
    return SimpleNamespace(trace=Trace(events, 2e-3),
                           peaks={"bf16_flops_s": 989e12, "hbm_bytes_s": 3.35e12},
                           layer={"step_ms": 80.0, "trace_steps": 2,
                                  "cfg": _cfg("mpvit_s", 256, 320, 12), "fa_calls": fa_calls})


def test_readers_on_a_synthetic_trace():
    run = _run(38)
    got = {name: harness.reader(name).read(run) for name in READERS}
    assert got["device_ms.mpvit"] == pytest.approx(0.25)
    assert got["fa_ms.mpvit"] == pytest.approx(0.1)
    assert got["dwconv_ms.mpvit"] == pytest.approx(0.05)
    cfg = run.layer["cfg"]
    assert got["fa_roofline.mpvit"] == pytest.approx(
        100 * flops_mpvit.fa_step_bytes(cfg) / 3.35e12 / 1e-4)
    assert got["train_mfu.mpvit"] == pytest.approx(
        100 * flops_mpvit.train_step_flops(cfg) / 0.08 / 989e12)


@pytest.mark.parametrize("calls", [None, 0])
def test_roofline_reads_nothing_without_fa_calls(calls):
    """A program without the ``FA/fwd`` counter (the parent's) gives 0
    calls, and the reader nothing."""
    assert harness.reader("fa_roofline.mpvit").read(_run(calls)) is None


def test_train_mpvit_runs_at_toy_sizes(tiny_preset):
    """The driver end to end on the CPU at the small preset: correct, the
    three checked steps compared, the half-batch fault and the float8
    control read."""
    sys.modules.setdefault("torch.utils.tensorboard", None)
    torch.set_num_threads(2)
    from portbench.run import execute

    cell = "train_mpvit.colvo_mpvit_s"
    w, config, traffic, limits, e2e, layer = harness.load_cell(cell)
    ctx = harness.Ctx(w, config, traffic, limits, 2**31 + 11, 1.0, False, torch.device("cpu"),
                      time.perf_counter(), overrides={**testing.TOY, "model.depth_net": TINY},
                      readings=("control", "half"))
    out = execute(ctx, e2e, layer)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_step_ms", "setup_s"}
    assert set(out["readings"]) == {"control", "half"}


def test_vo_i420_runs_at_toy_sizes():
    out = testing.toy_run("vo_i420.colvo_r18_family", readings=("control",))
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"vo_frames_per_s", "setup_s"}


def test_i420_planes_and_decoding_match_the_programs():
    """The driver's planes within one level of the program's
    ``rgb_to_i420`` (float64 against float32 rounding), and its decoding
    of the same planes the program's ``i420_to_rgb`` within 1e-6."""
    from colvo_torch.vo.stream import i420_to_rgb, rgb_to_i420

    rgb = np.random.default_rng(0).integers(0, 256, (3, 16, 24, 3), dtype=np.uint8)
    planes = vo_i420.encode(rgb)
    assert planes.shape == (3, 24, 24)
    assert np.abs(planes.astype(int) - rgb_to_i420(rgb).astype(int)).max() <= 1
    got = vo_i420.decode(planes, "cpu")
    want = i420_to_rgb(torch.from_numpy(planes))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_reference_and_drivers_load_no_jax():
    probe = ("import json, sys\nsys.modules.setdefault('torch.utils.tensorboard', None)\n"
             "import portbench.reference.mpvit, portbench.flops_mpvit\n"
             "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
             "import portbench.kinds.train_mpvit, portbench.kinds.vo_i420\n"
             "print(json.dumps([ref, sorted({m.split('.')[0] for m in sys.modules})]))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=harness.ROOT, check=True)
    ref, driver = (set(x) for x in json.loads(out.stdout.strip().splitlines()[-1]))
    assert not ref & (set(harness.FORBIDDEN) | {"colvo_torch"})
    assert not driver & set(harness.FORBIDDEN)
