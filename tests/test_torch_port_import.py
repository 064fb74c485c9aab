"""colvo_torch's family-checkpoint import and ``model.norm="none"`` against
colvo's, on the synthetic family modules of ``tests/test_torch_import.py``
(torchvision-named ResNet-18s and Monodepth2-named decoders with random
BatchNorm statistics): the imported weights equal colvo's import, and the
port's forward reproduces the family's torch forward and colvo's, at the
tolerances ``tests/test_torch_import.py`` holds colvo to."""

import inspect

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import colvo.runtime.torch_import as jax_import
from colvo import cli as jax_cli
from colvo.config import ModelConfig as JaxModelConfig
from colvo.models import ColVOModel as JaxModel
from colvo.runtime.checkpoint import fold_batchnorm as jax_fold_batchnorm
from colvo.runtime.checkpoint import load_params as jax_load_params
from colvo_torch import cli
from colvo_torch.config import ModelConfig
from colvo_torch.models import ColVOModel
from colvo_torch.runtime import export_npz, flax_params, load_npz, params_from_flax
from colvo_torch.runtime import torch_import
from test_torch_import import (TorchDepthDecoder, TorchPoseDecoder, TorchResNet18, _nchw,
                               _randomize_bn)

torch.set_num_threads(2)

H, W = 64, 96


@pytest.fixture(scope="module")
def family():
    torch.manual_seed(0)
    enc, dec = TorchResNet18(3).eval(), TorchDepthDecoder().eval()
    pose_enc, pose_dec = TorchResNet18(6).eval(), TorchPoseDecoder().eval()
    for m in (enc, pose_enc):
        _randomize_bn(m)
    return enc, dec, pose_enc, pose_dec


def _sds(family):
    return [m.state_dict() for m in family]


@pytest.fixture(scope="module")
def imported(family):
    """(the port's model on its import, colvo's model and its import)."""
    cfg = ModelConfig(dtype="float32", norm="none", dcdp_fusion=False)
    template = ColVOModel(cfg)
    template.reset_parameters(torch.Generator().manual_seed(0))
    sd = torch_import.import_family_checkpoint(template.state_dict(), *_sds(family))
    model = ColVOModel(cfg)
    model.load_state_dict(sd)
    model.eval()
    jcfg = JaxModelConfig(dtype="float32", norm="none", dcdp_fusion=False)
    jmodel = JaxModel(jcfg)
    jtemplate = jax.jit(jmodel.init)(jax.random.key(0), jnp.zeros((1, 2, H, W, 3)))
    jparams = jax_import.import_family_checkpoint(jtemplate, *_sds(family))
    return model, sd, jmodel, jparams


def test_import_equals_the_reference_import(imported):
    """Every entry: the port's import is params_from_flax of colvo's, to
    1e-6 (the BatchNorm fold computes in float32 in both)."""
    _, sd, _, jparams = imported
    flat = {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(jparams, sep="/").items()}
    want = params_from_flax(flat, ModelConfig(dtype="float32", norm="none", dcdp_fusion=False))
    assert sorted(sd) == sorted(want)
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=1e-6, msg=k)


def test_fold_batchnorm_equals_the_reference():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 5, 3, 3)).astype(np.float32)
    g, b, m = (rng.normal(size=8).astype(np.float32) for _ in range(3))
    v = rng.random(8).astype(np.float32) + 0.5
    got_w, got_b = torch_import.fold_batchnorm(*(torch.from_numpy(a) for a in (w, g, b, m, v)))
    want_w, want_b = jax_fold_batchnorm(np.transpose(w, (2, 3, 1, 0)), g, b, m, v)
    np.testing.assert_array_equal(got_w.numpy(), np.transpose(want_w, (3, 2, 0, 1)))
    np.testing.assert_array_equal(got_b.numpy(), want_b)


def test_depth_forward_matches_family_and_reference(family, imported):
    """Disparities at every scale and the bottleneck: against the family's
    torch forward and colvo's norm="none" forward, 2e-4."""
    enc, dec, *_ = family
    model, _, jmodel, jparams = imported
    x = np.random.default_rng(2).uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    with torch.no_grad():
        t_feats = enc(_nchw(x))
        t_disps = dec.forward_all(t_feats)
        disps, bneck = model.depth(_nchw(x))
    jd, jb = jax.jit(lambda p, i: jmodel.apply(p, i, method=jmodel.depth))(jparams, jnp.asarray(x))
    np.testing.assert_allclose(bneck.numpy(), t_feats[-1].numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(bneck.numpy(), np.transpose(np.asarray(jb), (0, 3, 1, 2)),
                               rtol=2e-4, atol=2e-4)
    for s in range(4):
        np.testing.assert_allclose(disps[s].numpy(), t_disps[s].numpy(), rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(disps[s].numpy(),
                                   np.transpose(np.asarray(jd[s]), (0, 3, 1, 2)),
                                   rtol=2e-4, atol=2e-4)


def test_pose_forward_matches_family_and_reference(family, imported):
    """(axisangle, translation): 1e-4 relative, 1e-5 absolute."""
    _, _, pose_enc, pose_dec = family
    model, _, jmodel, jparams = imported
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        t_aa, t_tr = pose_dec(pose_enc(torch.cat([_nchw(a), _nchw(b)], 1))[-1])
        aa, tr = model.pose(_nchw(a), _nchw(b), None)
    j_aa, j_tr = jax.jit(lambda p, x, y: jmodel.apply(p, x, y, None, method=jmodel.pose))(
        jparams, jnp.asarray(a), jnp.asarray(b))
    for got, want in ((aa, t_aa), (tr, t_tr), (aa, np.asarray(j_aa)), (tr, np.asarray(j_tr))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_checked_refuses_a_wrong_shape_or_key(family, imported):
    enc, dec, *_ = family
    _, sd, _, _ = imported
    bad = dict(enc.state_dict())
    bad["conv1.weight"] = torch.zeros(64, 4, 7, 7)
    with pytest.raises(ValueError, match="stem.weight"):
        torch_import.import_family_checkpoint(sd, bad, dec.state_dict())
    missing = {k: v for k, v in enc.state_dict().items() if not k.startswith("layer4.1.bn2")}
    with pytest.raises(KeyError):
        torch_import.import_family_checkpoint(sd, missing, dec.state_dict())
    with pytest.raises(ValueError, match="missing"):
        torch_import._checked({"a.weight": torch.zeros(2), "b.weight": torch.zeros(2)},
                              {"a.weight": torch.zeros(2)})


def test_depth_only_import_keeps_the_template_pose(family):
    enc, dec, *_ = family
    template = ColVOModel(ModelConfig(norm="none", dcdp_fusion=True)).state_dict()
    sd = torch_import.import_family_checkpoint(template, enc.state_dict(), dec.state_dict())
    for k, v in template.items():
        same = torch.equal(sd[k], v)
        assert same == (not k.startswith("depth.")), k
    enc_wrapped = {f"encoder.{k}": v for k, v in enc.state_dict().items()}
    enc_wrapped["encoder.fc.weight"] = torch.zeros(10, 512)
    sd2 = torch_import.import_family_checkpoint(template, enc_wrapped, dec.state_dict())
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


def test_cli_import_torch_equals_colvo_cli(family, tmp_path):
    """Both CLIs on the same family dir: the same .npz keys, values to
    1e-6; colvo's load_params reads the port's file, and the port's
    load_npz (norm="none") reads colvo's."""
    d = tmp_path / "family"
    d.mkdir()
    for name, m in zip(("encoder", "depth", "pose_encoder", "pose"), family):
        torch.save(m.state_dict(), d / f"{name}.pth")
    args = ["--model.dtype=float32", f"--data.height={H}", f"--data.width={W}"]
    assert cli.main(["import-torch", str(d), str(tmp_path / "port"), "--device", "cpu"] + args) == 0
    assert jax_cli.main(["import-torch", str(d), str(tmp_path / "ref")] + args) == 0
    got = np.load(tmp_path / "port.npz")
    want = np.load(tmp_path / "ref.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    jax_flat = flax.traverse_util.flatten_dict(jax_load_params(str(tmp_path / "port.npz")), sep="/")
    assert sorted(jax_flat) == sorted(want.files)
    cfg = ModelConfig(norm="none", dcdp_fusion=False)
    load_npz(str(tmp_path / "ref.npz"), cfg)
    with pytest.raises(KeyError):  # a norm="none" file does not fit a GroupNorm model
        load_npz(str(tmp_path / "port.npz"), ModelConfig(dcdp_fusion=False))


def test_norm_none_weights_cross_both_ways(tmp_path):
    """export_npz/load_npz and flax_params/params_from_flax carry the
    norm="none" tree (conv biases, no GroupNorm) and still raise on a key
    missing or left over."""
    cfg = ModelConfig(norm="none")
    model = ColVOModel(cfg)
    model.reset_parameters(torch.Generator().manual_seed(1))
    sd = model.state_dict()
    assert "depth.encoder.stem.bias" in sd and not any("norm" in k for k in sd)
    out = export_npz(sd, str(tmp_path / "w"))
    back = load_npz(out, cfg)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    flat = flax_params(sd)
    assert "params/depth/encoder/BasicBlock_0/Conv_0/bias" in flat
    with pytest.raises(KeyError, match="left over"):
        params_from_flax({**flat, "params/depth/encoder/_Norm_0/GroupNorm_0/scale": np.ones(64)},
                         cfg)
    flat.pop("params/depth/decoder/dispconv_0/bias")
    with pytest.raises(KeyError, match="missing"):
        params_from_flax(flat, cfg)


def test_load_family_checkpoint_dir(family, tmp_path):
    enc, dec, *_ = family
    with pytest.raises(FileNotFoundError, match="encoder.pth"):
        torch_import.load_family_checkpoint_dir(str(tmp_path))
    torch.save(enc.state_dict(), tmp_path / "encoder.pth")
    torch.save(dec.state_dict(), tmp_path / "depth.pth")
    sds = torch_import.load_family_checkpoint_dir(str(tmp_path))
    assert sorted(sds) == ["depth", "encoder"]
    assert all(torch.equal(sds["encoder"][k], v) for k, v in enc.state_dict().items())


_PAIRS = {name: (getattr(torch_import, name), getattr(jax_import, name)) for name in (
    "import_resnet_encoder", "import_depth_decoder", "import_pose_decoder",
    "import_family_checkpoint", "load_family_checkpoint_dir", "_checked")}
_PAIRS["fold_batchnorm"] = (torch_import.fold_batchnorm, jax_fold_batchnorm)


@pytest.mark.parametrize("name", sorted(_PAIRS))
def test_signatures_match_the_reference(name):
    got, want = _PAIRS[name]
    describe = lambda fn: [(p.name, p.kind, p.default)  # noqa: E731
                           for p in inspect.signature(fn).parameters.values()]
    assert describe(got) == describe(want)
