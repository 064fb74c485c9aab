"""The Depth Anything V2 depth net (``model.depth_net``: DINOv2 ViT + DPT
head, ``colvo_torch/models/vit.py`` and ``dpt.py``) on the CPU at float32,
against the plain reference ``portbench/reference/dpt.py`` on seeded
weights: the disparity, the snippet loss's terms and every gradient, at a
frame size of multiples of 14 (56×70) and at one the net resizes (64×96);
training through ``loop.train``, serving through ``InferenceRunner`` and
``run_vo``; the knob's guards, the weights that cannot cross to the JAX
package, and the default model left as it was.

The preset is small (width 64, 4 blocks, 4 heads, every block tapped,
DPT features 16), put into both preset tables for each test; every other
size is the published one (14-pixel patches, the 37×37 position table)."""

import json
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from colvo_torch.config import ColvoConfig, ModelConfig
from colvo_torch.data import SnippetDataset, render_sequence
from colvo_torch.kernels import attention, launch_counts
from colvo_torch.losses import snippet_loss
from colvo_torch.models import ColVOModel, vit
from colvo_torch.models.dpt import DPTDepthNet
from colvo_torch.runtime import InferenceRunner, export_npz, flax_params, params_from_flax
from colvo_torch.runtime import train as train_loop
from colvo_torch.runtime.torch_import import import_family_checkpoint
from colvo_torch.vo import run_vo
from portbench.reference import dpt as ref_dpt
from portbench.reference import model as ref_model
from portbench.reference.loss import snippet_loss as ref_snippet_loss

torch.set_num_threads(2)

TINY = "dpt_tiny14"
SMALL = dict(dim=64, depth=4, heads=4, taps=(0, 1, 2, 3), features=16,
             out_channels=(8, 16, 32, 32))
TERMS = ("loss/total", "loss/photometric", "loss/smoothness", "loss/geometric", "loss/gauge")


@pytest.fixture(autouse=True)
def tiny_preset(monkeypatch):
    monkeypatch.setitem(vit.PRESETS, TINY, SMALL)
    monkeypatch.setitem(ref_dpt.PRESETS, TINY, SMALL)


def _cfg(h=56, w=70) -> ColvoConfig:
    cfg = ColvoConfig()
    m = cfg.model
    m.depth_net, m.n_scales, m.dcdp_fusion, m.dtype = TINY, 1, False, "float32"
    cfg.data.height, cfg.data.width, cfg.data.batch_size = h, w, 2
    return cfg


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).double().norm() / (b.double().norm() + 1e-30))


def _snippets(h, w):
    """Two (target, previous, next) snippets of a rendered sequence and its K."""
    seq = render_sequence(n_frames=4, height=h, width=w, seed=3)
    frames = torch.from_numpy(np.stack([seq.frames[[1, 0, 2]], seq.frames[[2, 1, 3]]]))
    return frames.float(), torch.from_numpy(seq.k).float()


@pytest.mark.parametrize("hw", [(56, 70), (64, 96)], ids=["56x70", "64x96_resized"])
def test_dpt_depth_net_matches_the_reference(hw):
    """The chain in three links, each against the reference: the forward
    (every frame's disparity and the poses within 1e-5 relative); the loss
    on the program's outputs (each term within 1e-4 relative, its gradient
    to each output within 1e-3 relative L2); and the backward, the loss's
    cotangents through the reference net (every weight's gradient within
    1e-3 relative L2: ``test_torch_port_losses.py``'s bounds). The loss is
    not compared across the two forwards: their poses differ by ~1e-6,
    which can flip an automask near-tie and move the mean by ~3e-4."""
    cfg = _cfg(*hw)
    m = cfg.model
    w = ref_dpt.weights(m, 7, "cpu")
    model = ColVOModel(m)
    model.load_state_dict(w)
    frames, k = _snippets(*hw)

    disps, poses = model(frames)
    outs = [d[0] for d in disps] + [poses]
    total, aux = snippet_loss(disps, poses, frames, k, torch.linalg.inv(k), cfg.loss, m)
    cot = torch.autograd.grad(total, outs, retain_graph=True)
    total.backward()
    got = {n: p.grad for n, p in model.named_parameters()}

    params = {n: v.clone().requires_grad_(True) for n, v in w.items()}
    r_disps, r_poses = ref_dpt.snippet_forward(params, frames, m)
    r_outs = [d[0] for d in r_disps] + [r_poses]
    assert outs[0].shape == (2, *hw, 1)
    for i, (a, b) in enumerate(zip(outs, r_outs)):
        assert _rel(a.detach(), b.detach()) < 1e-5, i

    leaves = [o.detach().requires_grad_(True) for o in outs]
    terms = ref_snippet_loss([{0: d} for d in leaves[:-1]], leaves[-1], frames, k, cfg.loss, m)
    for key in TERMS:
        a = float((total if key == "loss/total" else aux[key]).detach())
        b = float(terms[key].detach())
        assert abs(a - b) <= 1e-4 * abs(b), key
    assert float(terms["loss/geometric"].detach()) > 0
    for i, (a, b) in enumerate(zip(cot, torch.autograd.grad(terms["loss/total"], leaves))):
        assert _rel(a, b) < 1e-3, i

    want = dict(zip(params, torch.autograd.grad(r_outs, list(params.values()), cot)))
    assert set(got) == set(want)
    worst = max(got, key=lambda n: _rel(got[n], want[n]))
    assert _rel(got[worst], want[worst]) < 1e-3, (worst, _rel(got[worst], want[worst]))


def test_remat_recomputes_the_blocks_with_the_same_gradients():
    """``model.remat`` recomputes each ViT block in the backward: the same
    loss and gradients, bit for bit on the CPU, and the same names."""
    grads = []
    for remat in (False, True):
        cfg = _cfg()
        cfg.model.remat = remat
        model = ColVOModel(cfg.model)
        model.load_state_dict(ref_dpt.weights(cfg.model, 3, "cpu"))
        frames, k = _snippets(56, 70)
        disps, poses = model(frames)
        loss, _ = snippet_loss(disps, poses, frames, k, torch.linalg.inv(k), cfg.loss, cfg.model)
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert set(grads[0]) == set(grads[1])
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n


def test_spec_names_the_programs_state_dict():
    m = _cfg().model
    sd = ColVOModel(m).state_dict()
    assert [(n, tuple(v.shape)) for n, v in sd.items()] == ref_dpt.spec(m)


def test_published_vitl_widths():
    """``dpt_vitl14`` builds DA-V2's ViT-L/14 and DPT head (``run.py``'s
    ``model_configs['vitl']``): 24 blocks of 1024, 16 heads, taps 4, 11,
    17 and 23, DPT features 256 and out_channels 256, 512, 1024, 1024."""
    m = ModelConfig(depth_net="dpt_vitl14", n_scales=1, dcdp_fusion=False)
    with torch.device("meta"):
        net = ColVOModel(m).depth
    enc, head = net.pretrained, net.depth_head
    assert len(enc.blocks) == 24 and enc.taps == (4, 11, 17, 23)
    assert enc.blocks[0].attn.heads == 16 and enc.blocks[0].mlp.fc1.weight.shape == (4096, 1024)
    assert [p.weight.shape[0] for p in head.projects] == [256, 512, 1024, 1024]
    assert head.scratch.layer1_rn.weight.shape == (256, 256, 3, 3)
    assert enc.pos_embed.shape == (1, 37 * 37 + 1, 1024)


def test_default_model_is_left_as_it_was():
    """The ResNet model keeps the reference's weight list, names, shapes and
    order (``portbench/reference/model.py::spec``), and no buffer."""
    m = ModelConfig()
    model = ColVOModel(m)
    assert [(n, tuple(v.shape)) for n, v in model.state_dict().items()] == ref_model.spec(m)
    assert not list(model.buffers())


@pytest.mark.parametrize("knob,match", [
    ({"n_scales": 4}, "n_scales must be 1"),
    ({"dcdp_fusion": True}, "dcdp_fusion must be false"),
    ({"depth_net": "dpt_vith14"}, "model.depth_net must be"),
])
def test_knob_guards_raise(knob, match):
    m = _cfg().model
    for k, v in knob.items():
        setattr(m, k, v)
    with pytest.raises(ValueError, match=match):
        ColVOModel(m)


def test_loop_trains_three_steps(tmp_path):
    sys.modules.setdefault("torch.utils.tensorboard", None)
    cfg = _cfg()
    cfg.data.augment = False
    cfg.train.log_every = 1
    cfg.train.eval_every_epochs = 0
    cfg.train.ckpt_dir = str(tmp_path / "ckpt")
    seq = render_sequence(n_frames=8, height=56, width=70, seed=3)
    ds = SnippetDataset([seq.frames], [seq.k], cfg.data.frame_offsets)
    model, state = train_loop(cfg, ds, log_dir=str(tmp_path / "log"), max_steps=3,
                              device="cpu")
    assert state.step == 3 and isinstance(model.depth, DPTDepthNet)
    rows = [json.loads(r) for r in (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss/total"] for r in rows if "loss/total" in r]
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_serving_and_vo_take_the_dpt_net():
    """``infer_coupled`` gives full-resolution depth, and ``run_vo`` its
    trajectory and depths, with the DPT net, at a resized frame size."""
    cfg = _cfg(64, 96)
    w = ref_dpt.weights(cfg.model, 5, "cpu")
    runner = InferenceRunner(cfg, w, device="cpu")
    seq = render_sequence(n_frames=7, height=64, width=96, seed=4)
    da, db, aa, tr = runner.infer_coupled(seq.frames[:1], seq.frames[1:2])
    assert da.shape == db.shape == (1, 64, 96) and np.isfinite(da).all()
    assert aa.shape == tr.shape == (1, 3)
    frames = (seq.frames * 255).astype(np.uint8)
    result = run_vo(runner, iter(frames), chunk_size=3, depth_dtype="uint8",
                    symmetric_pose=True, keyframe_every=2)
    assert result.poses.shape == (7, 4, 4) and np.isfinite(result.poses).all()
    assert result.keyframe_ids == [0, 2, 4, 6] and result.depths[0].shape == (64, 96)


def test_dpt_weights_do_not_cross_to_the_jax_package(tmp_path):
    """``export_npz``/``flax_params`` and ``params_from_flax`` refuse a DPT
    depth net with a ValueError, as the family import does."""
    m = _cfg().model
    sd = ColVOModel(m).state_dict()
    with pytest.raises(ValueError, match="no DPT depth net"):
        export_npz(sd, str(tmp_path / "w.npz"))
    with pytest.raises(ValueError, match="no DPT depth net"):
        flax_params(sd)
    with pytest.raises(ValueError, match="no DPT depth net"):
        params_from_flax({}, m)
    assert not list(tmp_path.iterdir())


def test_dpt_template_is_refused_by_the_family_import():
    sd = ColVOModel(_cfg().model).state_dict()
    with pytest.raises(ValueError, match="not the ResNet one"):
        import_family_checkpoint(sd, {}, {})


def test_attention_on_the_cpu_is_the_plain_softmax_and_counts_no_launch():
    q, k, v = (torch.randn(2, 4, 9, 16) for _ in range(3))
    before = launch_counts()
    out = attention(q, k, v)
    torch.testing.assert_close(out, F.scaled_dot_product_attention(q, k, v), atol=1e-6,
                               rtol=1e-5)
    assert launch_counts() == before
