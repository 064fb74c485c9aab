"""colvo_torch.models and InferenceRunner against colvo's, with the same
weights carried across by params_from_flax, at float32 on the CPU."""

import math

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvo.config import ColvoConfig as JaxConfig
from colvo.models import ColVOModel as JaxModel
from colvo.runtime.checkpoint import load_params
from colvo.runtime.infer import InferenceRunner as JaxRunner
from colvo_torch.config import ColvoConfig
from colvo_torch.models import ColVOModel
from colvo_torch.runtime import InferenceRunner, export_npz, flax_params, params_from_flax

torch.set_num_threads(2)

B, H, W = 2, 64, 96


def _configs():
    jcfg, tcfg = JaxConfig(), ColvoConfig()
    jcfg.model.dtype = tcfg.model.dtype = "float32"
    return jcfg, tcfg


def _random_weights(model_cfg):
    """Random weights with every parameter away from its init value (so a
    mis-mapped bias or norm scale shows), as flat Flax params."""
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in ColVOModel(model_cfg).state_dict().items():
        if v.ndim == 4:
            a = rng.normal(0, 1 / math.sqrt(v[0].numel()), v.shape)
        elif "norm" in k and k.endswith("weight"):
            a = 1 + 0.1 * rng.normal(size=v.shape)
        else:
            a = 0.05 * rng.normal(size=v.shape)
        sd[k] = torch.tensor(a, dtype=torch.float32)
    return flax_params(sd)


@pytest.fixture(scope="module")
def weights():
    return _random_weights(_configs()[1].model)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(1).random((B, 3, H, W, 3), dtype=np.float32)


def test_snippet_forward_matches(weights, frames):
    """Disparities of every frame and scale, the depth bottleneck and the
    DCDP-fused poses agree to 1e-4."""
    _check_snippet_forward(weights, frames, *_configs())


def test_snippet_forward_without_dcdp_fusion_matches(frames):
    """``model.dcdp_fusion=False`` under GroupNorm (the pose net reads the
    frames alone): the same quantities agree to 1e-4."""
    jcfg, tcfg = _configs()
    jcfg.model.dcdp_fusion = tcfg.model.dcdp_fusion = False
    assert jcfg.model.norm == tcfg.model.norm == "group"
    _check_snippet_forward(_random_weights(tcfg.model), frames, jcfg, tcfg)


def _check_snippet_forward(weights, frames, jcfg, tcfg):
    jm = JaxModel(jcfg.model)
    params = flax.traverse_util.unflatten_dict(weights, sep="/")
    jd, jp = jax.jit(jm.apply)(params, jnp.asarray(frames))
    _, jb = jax.jit(lambda p, x: jm.apply(p, x, method=jm.depth))(params, jnp.asarray(frames[:, 0]))

    model = ColVOModel(tcfg.model)
    model.load_state_dict(params_from_flax(weights, tcfg.model))
    with torch.no_grad():
        td, tp = model(torch.tensor(frames))
        _, tb = model.depth(torch.tensor(frames[:, 0]).permute(0, 3, 1, 2))
    assert len(td) == 3
    for f in range(3):
        assert sorted(td[f]) == [0, 1, 2, 3]
        for s in range(4):
            assert td[f][s].shape == (B, H >> s, W >> s, 1)
            np.testing.assert_allclose(td[f][s].numpy(), np.asarray(jd[f][s]), atol=1e-4)
    np.testing.assert_allclose(tb.permute(0, 2, 3, 1).numpy(), np.asarray(jb), atol=1e-4)
    assert tp.shape == (B, 2, 6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)


def test_infer_coupled_matches(weights, frames):
    jcfg, tcfg = _configs()
    ref = JaxRunner(jcfg, flax.traverse_util.unflatten_dict(weights, sep="/"))
    runner = InferenceRunner(tcfg, params_from_flax(weights), device="cpu")
    a, b = frames[:, 0], frames[:, 1]
    for got, want in zip(runner.infer_coupled(a, b), ref.infer_coupled(a, b)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(runner.infer_pose(a, b),
                               np.concatenate(ref.infer_coupled(a, b)[2:], -1), atol=1e-6)
    depth, disp = runner.infer_depth(a)
    np.testing.assert_allclose(depth, ref.infer_coupled(a, b)[0], rtol=1e-4)
    assert disp.shape == (B, H, W)


def test_npz_roundtrip_through_reference_loader(weights, tmp_path):
    """export_npz writes what colvo's load_params reads, and
    params_from_flax inverts it exactly."""
    sd = params_from_flax(weights)
    path = export_npz(sd, str(tmp_path / "w"))
    flat = flax.traverse_util.flatten_dict(load_params(path), sep="/")
    assert flat.keys() == weights.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], weights[k])
    back = params_from_flax(flat)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize("fault", ["missing", "left_over", "shape"])
def test_params_from_flax_rejects_mismatch(weights, fault):
    flat = dict(weights)
    key = "params/pose_decoder/pose_2/kernel"
    if fault == "missing":
        del flat[key]
    elif fault == "left_over":
        flat["params/pose_decoder/pose_3/kernel"] = flat[key]
    else:
        flat[key] = flat[key][..., :5]
    with pytest.raises((KeyError, ValueError)):
        params_from_flax(flat)


def test_init_is_flax_like():
    """lecun-normal (fan-in, truncated at 2σ) conv kernels, zero biases,
    GroupNorm scale 1 / bias 0 — the distribution Flax starts from."""
    _, tcfg = _configs()
    model = ColVOModel(tcfg.model)
    model.reset_parameters(torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        if p.ndim == 4:
            std = 1 / math.sqrt(p[0].numel())
            if p.numel() > 50_000:
                assert abs(p.std().item() / std - 1) < 0.05, name
            assert p.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6, name
        elif "norm" in name and name.endswith("weight"):
            assert torch.all(p == 1), name
        else:
            assert torch.all(p == 0), name


@pytest.mark.parametrize("knob,value", [("remat", True), ("batched_snippet", False)])
def test_off_default_model_knobs_raise(knob, value):
    """model.remat and model.batched_snippet=false are ported (their
    parity: tests/test_torch_port_knobs_train.py): the model builds with the
    default's state_dict keys, so weights and checkpoints carry across;
    with the knob, a norm other than "group" or "none" is still refused."""
    _, tcfg = _configs()
    setattr(tcfg.model, knob, value)
    _, default = _configs()
    assert list(ColVOModel(tcfg.model).state_dict()) == list(
        ColVOModel(default.model).state_dict())
    tcfg.model.norm = "batch"
    with pytest.raises(ValueError, match="model.norm"):
        ColVOModel(tcfg.model)
