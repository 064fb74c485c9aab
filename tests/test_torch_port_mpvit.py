"""MPViT's depth encoder (``model.depth_net="mpvit_s"``,
``colvo_torch/models/mpvit.py``) under the full ColVO objective on the CPU
at float32, against the plain reference ``portbench/reference/mpvit.py``
on seeded weights: the pyramid, the four disparities and the DCDP poses,
the loss's terms and every gradient, BatchNorm's running statistics after
a training forward; serving on running statistics; the loop with its
checkpoint; the knob's guards; and the ResNet model left as it was.

The preset is small (embed dims 16, 24, 32 and 40, layers 1, 1, 2 and 1),
put into both preset tables for each test; every other size is the
published one (MPViT-Small's paths 2, 3, 3, 3, 8 heads, MLP ratio 4, the
CRPE windows 3, 5 and 7 over 2, 3 and 3 heads)."""

import hashlib
import json
import sys

import numpy as np
import pytest
import torch

from colvo_torch.config import ColvoConfig, ModelConfig
from colvo_torch.data import SnippetDataset, render_sequence
from colvo_torch.losses import snippet_loss
from colvo_torch.models import ColVOModel, mpvit
from colvo_torch.models.depth_decoder import DepthDecoder
from colvo_torch.models.encoder import ENCODER_CHANNELS
from colvo_torch.models.mpvit import MPViTDepthNet
from colvo_torch.models.posenet import DCDPFusion
from colvo_torch.runtime import InferenceRunner, export_npz
from colvo_torch.runtime import train as train_loop
from colvo_torch.runtime.checkpoint import CheckpointManager
from colvo_torch.vo import run_vo
from portbench.reference import model as ref_model
from portbench.reference import mpvit as ref_mpvit
from portbench.reference import train as ref_train
from portbench.reference.loss import snippet_loss as ref_snippet_loss

torch.set_num_threads(2)

TINY = "mpvit_tiny"
SMALL = dict(num_path=(2, 3, 3, 3), num_layers=(1, 1, 2, 1), embed_dims=(16, 24, 32, 40),
             mlp_ratio=4, heads=8)
TERMS = ("loss/total", "loss/photometric", "loss/smoothness", "loss/geometric", "loss/gauge")


@pytest.fixture(autouse=True)
def tiny_preset(monkeypatch):
    monkeypatch.setitem(mpvit.PRESETS, TINY, SMALL)
    monkeypatch.setitem(ref_mpvit.PRESETS, TINY, SMALL)


def _cfg(h=64, w=96) -> ColvoConfig:
    cfg = ColvoConfig()
    m = cfg.model
    m.depth_net, m.n_scales, m.dcdp_fusion, m.dtype = TINY, 4, True, "float32"
    cfg.data.height, cfg.data.width, cfg.data.batch_size = h, w, 2
    return cfg


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).double().norm() / (b.double().norm() + 1e-30))


def _snippets(h=64, w=96):
    """Two (target, previous, next) snippets of a rendered sequence and its K."""
    seq = render_sequence(n_frames=4, height=h, width=w, seed=3)
    frames = torch.from_numpy(np.stack([seq.frames[[1, 0, 2]], seq.frames[[2, 1, 3]]]))
    return frames.float(), torch.from_numpy(seq.k).float()


def _buffers(model) -> dict:
    return {n: b for n, b in model.state_dict().items() if n in ref_mpvit.buffers([n])}


def test_mpvit_matches_the_reference_in_a_training_step():
    """The chain in three links, each against the reference, as the DPT
    net's test holds it: the forward (the pyramid's shapes, every frame's
    four disparities and the DCDP poses within 1e-5 relative); the loss on
    the program's outputs (each term within 1e-4 relative, its gradient to
    each output within 1e-3 relative L2); the backward (every weight's
    gradient within 1e-3 relative L2, but those BatchNorm makes round-off).
    After the forward, every BatchNorm's
    running mean and variance within 1e-5 relative of the reference's
    update, and its count 1."""
    cfg = _cfg()
    m = cfg.model
    w = ref_mpvit.weights(m, 7, "cpu")
    model = ColVOModel(m)
    model.load_state_dict(w)
    model.train()
    frames, k = _snippets()

    feats = model.depth.encoder(frames[:, 0].permute(0, 3, 1, 2))
    assert [tuple(f.shape[1:]) for f in feats] == [(16, 32, 48), (24, 16, 24), (32, 8, 12),
                                                  (40, 4, 6), (40, 2, 3)]
    model.load_state_dict(w)  # the probe above moved the running statistics
    disps, poses = model(frames)
    assert sorted(disps[0]) == [0, 1, 2, 3] and poses.shape == (2, 2, 6)
    outs = [d[s] for d in disps for s in range(4)] + [poses]
    total, aux = snippet_loss(disps, poses, frames, k, torch.linalg.inv(k), cfg.loss, m)
    cot = torch.autograd.grad(total, outs, retain_graph=True)
    total.backward()
    got = {n: p.grad for n, p in model.named_parameters()}

    params = {n: (v.clone().requires_grad_(True) if v.is_floating_point() else v)
              for n, v in w.items()}
    running: dict = {}
    r_disps, r_poses = ref_mpvit.snippet_forward(params, frames, m, running=running)
    r_outs = [d[s] for d in r_disps for s in range(4)] + [r_poses]
    for i, (a, b) in enumerate(zip(outs, r_outs)):
        assert a.shape == b.shape and _rel(a.detach(), b.detach()) < 1e-5, i

    bufs = _buffers(model)
    assert set(running) == {n for n in bufs if not n.endswith("num_batches_tracked")}
    for n, v in running.items():
        assert _rel(bufs[n], v) < 1e-5, n
    assert all(int(v) == 1 for n, v in bufs.items() if n.endswith("num_batches_tracked"))

    leaves = [o.detach().requires_grad_(True) for o in outs]
    per_frame = [{s: leaves[4 * i + s] for s in range(4)} for i in range(3)]
    terms = ref_snippet_loss(per_frame, leaves[-1], frames, k, cfg.loss, m)
    for key in TERMS:
        a = float((total if key == "loss/total" else aux[key]).detach())
        b = float(terms[key].detach())
        assert abs(a - b) <= 1e-4 * abs(b), key
    assert float(terms["loss/geometric"].detach()) > 0
    for i, (a, b) in enumerate(zip(cot, torch.autograd.grad(terms["loss/total"], leaves))):
        assert _rel(a, b) < 1e-3, i

    names = [n for n, v in params.items() if v.requires_grad and n not in running]
    grads = torch.autograd.grad(r_outs, [params[n] for n in names], cot, allow_unused=True)
    want = dict(zip(names, grads))
    assert set(got) == {n for n in names if not n.endswith("num_batches_tracked")}
    # A bias added to every token of a path's last block, and so every
    # position of a channel, reaches the aggregate's BatchNorm, which takes
    # it back out: such leaves' gradients are round-off on both sides.
    keep = ref_train.moving_leaves({n: want[n] for n in got})
    assert len(keep) > 0.9 * len(got)
    worst = max(keep, key=lambda n: _rel(got[n], want[n]))
    assert _rel(got[worst], want[worst]) < 1e-3, (worst, _rel(got[worst], want[worst]))


def test_spec_names_the_programs_state_dict():
    """Weights and BatchNorm buffers, names, shapes and order."""
    m = _cfg().model
    sd = ColVOModel(m).state_dict()
    assert [(n, tuple(v.shape)) for n, v in sd.items()] == ref_mpvit.spec(m)


def test_serving_on_running_statistics_matches_the_reference():
    """``infer_coupled`` (``.eval()``: BatchNorm reads its running
    statistics, here moved off 0 and 1) against the reference's eval
    forward: depths within 1e-4 relative, poses within 1e-4 relative."""
    cfg = _cfg()
    w = ref_mpvit.weights(cfg.model, 5, "cpu")
    gen = torch.Generator().manual_seed(1)
    for n in ref_mpvit.buffers(w):
        if n.endswith("running_mean"):
            w[n] = 0.1 * torch.randn(w[n].shape, generator=gen)
        elif n.endswith("running_var"):
            w[n] = 0.5 + torch.rand(w[n].shape, generator=gen)
    runner = InferenceRunner(cfg, w, device="cpu")
    seq = render_sequence(n_frames=3, height=64, width=96, seed=4)
    da, db, aa, tr = runner.infer_coupled(seq.frames[:2], seq.frames[1:3])
    img = torch.from_numpy(seq.frames).float().permute(0, 3, 1, 2)
    sd_a, sd_b, r_aa, r_tr = ref_mpvit.pair_forward(w, img[:2], img[1:3], cfg.model)
    assert _rel(1.0 / torch.from_numpy(da).double(), sd_a.double()) < 1e-4
    assert _rel(1.0 / torch.from_numpy(db).double(), sd_b.double()) < 1e-4
    assert _rel(torch.from_numpy(aa), r_aa) < 1e-4 and _rel(torch.from_numpy(tr), r_tr) < 1e-4


def test_loop_trains_and_checkpoints_the_running_statistics(tmp_path):
    """Two steps through ``loop.train`` (the captured step's body on the
    CPU) at four scales with DCDP: finite losses, every BatchNorm's count 2
    and its statistics moved; the final checkpoint holds them and restores
    them into a fresh model, whose eval forward is the trained one's bit for
    bit; ``run_vo`` runs on them."""
    sys.modules.setdefault("torch.utils.tensorboard", None)
    cfg = _cfg()
    cfg.data.augment = False
    cfg.train.log_every = 1
    cfg.train.eval_every_epochs = 0
    cfg.train.ckpt_dir = str(tmp_path / "ckpt")
    seq = render_sequence(n_frames=8, height=64, width=96, seed=3)
    ds = SnippetDataset([seq.frames], [seq.k], cfg.data.frame_offsets)
    model, state = train_loop(cfg, ds, log_dir=str(tmp_path / "log"), max_steps=2,
                              device="cpu")
    assert state.step == 2 and isinstance(model.depth, MPViTDepthNet)
    rows = [json.loads(r) for r in (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss/total"] for r in rows if "loss/total" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    bufs = _buffers(model)
    assert all(int(v) == 2 for n, v in bufs.items() if n.endswith("num_batches_tracked"))
    assert all(float(v.abs().max()) > 0 for n, v in bufs.items() if n.endswith("running_mean"))

    payload, step, _ = CheckpointManager(str(tmp_path / "ckpt")).load()
    assert step == 2
    for n, v in bufs.items():
        assert torch.equal(payload["model"][n], v), n
    fresh = ColVOModel(cfg.model)
    fresh.load_state_dict(payload["model"])
    x = torch.from_numpy(seq.frames[:2]).float().permute(0, 3, 1, 2)
    with torch.no_grad():
        a, b = model.eval().depth(x), fresh.eval().depth(x)
    assert all(torch.equal(a[0][s], b[0][s]) for s in a[0])

    runner = InferenceRunner(cfg, payload["model"], device="cpu")
    frames = (seq.frames * 255).astype(np.uint8)
    result = run_vo(runner, iter(frames), chunk_size=3, depth_dtype="float16",
                    symmetric_pose=True, keyframe_every=2)
    assert result.poses.shape == (8, 4, 4) and np.isfinite(result.poses).all()


def test_published_mpvit_small_widths():
    """``mpvit_s`` builds mpvit_small's encoder: paths 2, 3, 3, 3, layers 1,
    3, 6, 3, dims 64, 128, 216, 288, 8 heads, MLP 4×, and the pyramid (64,
    128, 216, 288, 288) into the decoder and the fusion."""
    m = ModelConfig(depth_net="mpvit_s")
    with torch.device("meta"):
        model = ColVOModel(m)
    enc = model.depth.encoder
    assert [len(s.patch_embeds) for s in enc.patch_embed_stages] == [2, 3, 3, 3]
    assert [len(s.mhca_blks[0].MHCA_layers) for s in enc.mhca_stages] == [1, 3, 6, 3]
    blk = enc.mhca_stages[3].mhca_blks[0].MHCA_layers[0]
    assert blk.factoratt_crpe.heads == 8 and blk.mlp.fc1.weight.shape == (1152, 288)
    assert [c.weight.shape[-1] for c in enc.mhca_stages[2].mhca_blks[0].crpe.conv_list] == [3, 5, 7]
    assert [c.weight.shape[0] for c in enc.mhca_stages[2].mhca_blks[0].crpe.conv_list] == \
        [54, 81, 81]
    assert model.depth.channels == (64, 128, 216, 288, 288)
    assert model.depth.decoder.blocks[0].conv.weight.shape[1] == 288
    assert model.fusion.depth_proj[0].weight.shape == (64, 288, 1, 1)
    n = sum(p.numel() for p in enc.parameters())
    assert 22.5e6 < n < 22.7e6, n  # mpvit_small's 22.8 M less its 1000-class head


def test_default_model_is_left_as_it_was():
    """The ResNet model: the reference's names, shapes and order, no
    buffer, the same initial weights from a generator (their digest), and
    the decoder and fusion built with the ResNet's channels named are the
    default ones bit for bit."""
    m = ModelConfig()
    model = ColVOModel(m)
    assert [(n, tuple(v.shape)) for n, v in model.state_dict().items()] == ref_model.spec(m)
    assert not list(model.buffers())
    model.reset_parameters(torch.Generator().manual_seed(0))
    digest = hashlib.sha256()
    for v in model.state_dict().values():
        digest.update(v.numpy().tobytes())
    assert digest.hexdigest()[:16] == RESNET_INIT_DIGEST
    dec = DepthDecoder(4, torch.bfloat16, "same", channels=ENCODER_CHANNELS)
    dec.load_state_dict(model.depth.decoder.state_dict())
    fusion = DCDPFusion(64, 2, torch.bfloat16, ENCODER_CHANNELS[-1])
    fusion.load_state_dict(model.fusion.state_dict())
    gen = torch.Generator().manual_seed(2)
    feats = [torch.randn(1, c, 64 >> i, 96 >> i, generator=gen)
             for i, c in enumerate(ENCODER_CHANNELS, start=1)]
    with torch.no_grad():
        a, b = model.depth.decoder(feats), dec(feats)
        pose = torch.randn(1, 512, 2, 3, generator=gen)
        fa = model.fusion(pose, [feats[-1], feats[-1]])
        fb = fusion(pose, [feats[-1], feats[-1]])
    assert all(torch.equal(a[s], b[s]) for s in a) and torch.equal(fa, fb)


# reset_parameters(Generator().manual_seed(0)) of the default ResNet model,
# as it was before the decoder and fusion took their channels as arguments
RESNET_INIT_DIGEST = "936ce48e8ab89bd7"


def test_remat_raises():
    m = _cfg().model
    m.remat = True
    with pytest.raises(ValueError, match="model.remat does not cover"):
        ColVOModel(m)


def test_mpvit_weights_do_not_cross_to_the_jax_package(tmp_path):
    sd = ColVOModel(_cfg().model).state_dict()
    with pytest.raises(ValueError, match="no MPViT"):
        export_npz(sd, str(tmp_path / "w.npz"))
    assert not list(tmp_path.iterdir())
