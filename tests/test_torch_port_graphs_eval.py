"""The last two of colvo's jitted programs as colvo_torch programs, on the
CPU (``runtime.graphs.Graphed``'s CPU path: the body runs eagerly on the
program's static buffers): the device store's batch program (the
reference's ``_assemble`` + ``augment_fn``) against eager ``gather`` +
``device_augment`` bit for bit and against the reference's on its own
draws, and the eval hook's captured forward (the reference's
``_eval_fwd``) against the reference's hook, across calls and across a
replaced model."""

import gc
import math
import time
import types
import weakref
from unittest import mock

import flax
import jax
import numpy as np
import pytest
import torch

from colvo.config import ColvoConfig as JaxConfig
from colvo.config import DataConfig as JaxDataConfig
from colvo.data.device_store import DeviceSnippetStore as JaxStore
from colvo.models import ColVOModel as JaxModel
from colvo.pipelines import make_training_eval_hook as jax_eval_hook
from colvo_torch.config import ColvoConfig, DataConfig
from colvo_torch.data import device_store, render_sequence
from colvo_torch.data.device_store import DeviceSnippetStore, device_augment, gather
from colvo_torch.models import ColVOModel
from colvo_torch.pipelines import TrainingEvalHook, make_training_eval_hook
from colvo_torch.runtime import flax_params
from colvo_torch.runtime import spans
from colvo_torch.runtime.graphs import Graphed

torch.set_num_threads(2)

H, W = 64, 96


@pytest.fixture(scope="module")
def seq():
    return render_sequence(n_frames=12, height=H, width=W, seed=4)


def _copy(batch):
    return {k: v.clone() for k, v in batch.items()}


@pytest.mark.parametrize("augment", [True, False])
def test_batch_program_equals_eager_gather_and_augment(seq, augment):
    """Two epochs of the store's batches (each a call of its program) bit
    for bit the eager batches from the same seed: the reference's
    ``default_rng(seed)`` permutations, gather, and ``device_augment`` from a
    generator seeded alike."""
    cfg = DataConfig(height=H, width=W, batch_size=2, augment=augment)
    store = DeviceSnippetStore([seq.frames, seq.frames[::-1]], [seq.k] * 2, device="cpu")
    got = [_copy(b) for b in store.batches(cfg, seed=3, epochs=2)]

    rng = np.random.default_rng(3)
    gen = torch.Generator().manual_seed(3)
    want = []
    for _ in range(2):
        order = torch.from_numpy(rng.permutation(store.n_snippets))
        for s in range(0, store.n_snippets - 1, 2):
            clean = gather(store.frames, store.table, order[s:s + 2])
            aug, clean = device_augment(clean, gen, cfg) if augment else (clean, clean)
            want.append({"frames": aug, "frames_clean": clean, "k": store.k})
    assert len(got) == len(want) == 2 * (store.n_snippets // 2)
    for g, w in zip(got, want):
        for key in w:
            assert torch.equal(g[key], w[key]), key
    if augment:  # the draws differ from batch to batch
        assert not torch.equal(got[0]["frames"] - got[0]["frames_clean"],
                               got[1]["frames"] - got[1]["frames_clean"])


def test_batch_program_outputs_are_its_static_buffers(seq):
    """A batch is the program's static outputs: the next batch overwrites
    it in place (the documented contract a caller that keeps one copies
    against)."""
    cfg = DataConfig(height=H, width=W, batch_size=2, augment=True)
    it = DeviceSnippetStore([seq.frames], [seq.k], device="cpu").batches(cfg, seed=0)
    first = next(it)
    kept = _copy(first)
    second = next(it)
    assert second is not first and second["frames"] is first["frames"]  # a fresh dict, one buffer
    assert not torch.equal(first["frames"], kept["frames"])


def test_batch_program_on_the_references_draws_equals_its_assemble_and_augment(seq):
    """The program with the reference's augmentation draws fed in (its key
    split per batch and the five uniform/bernoulli calls of
    ``colvo/data/device_store.py:40-64``) against the reference's
    ``_assemble`` + ``augment_fn`` over two epochs: clean frames bit for
    bit, augmented ones to 1e-6 abs (test_torch_port_device_store.py's
    bound for ``apply_augment``)."""
    jcfg = JaxDataConfig(height=H, width=W, batch_size=4, augment=True)
    cfg = DataConfig(height=H, width=W, batch_size=4, augment=True)
    sequences, ks = [seq.frames, seq.frames[2:]], [seq.k, seq.k]
    ref = JaxStore(sequences, ks)
    want = list(ref.batches(jcfg, seed=5, epochs=2))

    key = jax.random.key(5)
    draws = []
    for _ in want:
        key, sub = jax.random.split(key)
        k_flip, k_b, k_c, k_s, k_h = jax.random.split(sub, 5)
        shape = (4, 1, 1, 1, 1)
        d = {"flip": jax.random.bernoulli(k_flip, 0.5, (4,))}
        for name, k_ in (("brightness", k_b), ("contrast", k_c), ("saturation", k_s)):
            a = getattr(jcfg, name)
            d[name] = jax.random.uniform(k_, shape, minval=1 - a, maxval=1 + a)
        d["hue"] = jax.random.uniform(k_h, shape, minval=-jcfg.hue, maxval=jcfg.hue)
        draws.append({k: torch.from_numpy(np.array(v).reshape(4)) for k, v in d.items()})
    fed = iter(draws)

    port = DeviceSnippetStore(sequences, ks, device="cpu")
    with mock.patch.object(device_store, "draw_augment", lambda *a, **kw: next(fed)):
        got = [_copy(b) for b in port.batches(cfg, seed=5, epochs=2)]
    assert len(got) == len(want) == 2 * (port.n_snippets // 4)
    assert any(0 < int(d["flip"].sum()) < 4 for d in draws)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["frames_clean"].numpy(), np.asarray(w["frames_clean"]))
        np.testing.assert_allclose(g["frames"].numpy(), np.asarray(w["frames"]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(g["k"].numpy(), np.asarray(w["k"]))


def _configs():
    jcfg, tcfg = JaxConfig(), ColvoConfig()
    for c in (jcfg, tcfg):
        c.model.dtype = "float32"
        c.data.height, c.data.width = H, W
    return jcfg, tcfg


def _weights(cfg, seed):
    """Random weights with the init's scales (the loop test's)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in ColVOModel(cfg.model).state_dict().items():
        if v.ndim == 4:
            a = rng.normal(0, 1 / math.sqrt(v[0].numel()), v.shape)
        elif "norm" in k and k.endswith("weight"):
            a = 1 + 0.1 * rng.normal(size=v.shape)
        else:
            a = 0.05 * rng.normal(size=v.shape)
        sd[k] = torch.tensor(a, dtype=torch.float32)
    return sd


def _reference_scalars(jcfg, sd):
    params = flax.traverse_util.unflatten_dict(flax_params(sd), sep="/")
    return jax_eval_hook(jcfg, JaxModel(jcfg.model))(0, types.SimpleNamespace(params=params), None)


def _model(cfg, sd):
    model = ColVOModel(cfg.model)
    model.load_state_dict(sd)
    model.train()
    return model


def _assert_close(got, want):
    assert sorted(got) == sorted(want) and "eval/abs_rel" in got and "eval/ate" in got
    for k in want:  # test_torch_port_loop.py::test_eval_hook_matches_the_reference's bound
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-12), (k, got[k], want[k])


def test_captured_eval_hook_matches_the_reference_across_calls():
    """The hook's program against the reference's hook on the same weights,
    at its first call (which makes the program) and at a second (which
    reuses it); its outputs equal its eager body's bit for bit; eval mode
    and no gradients hold inside the body; the split of the call's time is
    recorded."""
    jcfg, tcfg = _configs()
    sd = _weights(tcfg, 0)
    want = _reference_scalars(jcfg, sd)
    model = _model(tcfg, sd)
    hook = make_training_eval_hook(tcfg, model)
    assert isinstance(hook, TrainingEvalHook) and hook.program is None
    seen = []
    model.depth.register_forward_pre_hook(
        lambda m, args: seen.append((m.training, torch.is_grad_enabled())))
    state = types.SimpleNamespace(model=model)
    first = hook(0, state, None)
    program = hook.program
    since = time.perf_counter_ns()
    second = hook(1, state, None)
    _assert_close(first, want)
    assert second == first and hook.program is program and isinstance(program, Graphed)
    assert len(program.programs) == 1
    assert len(seen) == 4 and set(seen) == {(False, False)} and model.training  # 2 a forward
    parts = [s for s in spans.snapshot().spans if s.name.startswith("eval.")
             and s.start_ns >= since and s.attrs.get("step") == 1]
    assert [s.name for s in parts] == ["eval.queue", "eval.forward", "eval.metrics",
                                       "eval.panels"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(parts, parts[1:]))
    assert all(s.end_ns >= s.start_ns and s.parent is None for s in parts)
    assert [(s.name, s.attrs["program"]) for s in spans.snapshot().spans
            if s.parent == parts[1].id] == [("graph.copy_in", "eval_forward"),
                                            ("graph.replay", "eval_forward")]
    out = program()
    model.eval()
    for a, b in zip(out, hook.forward(model)):
        assert torch.equal(a, b)


def test_eval_hook_follows_a_replaced_model_and_drops_its_program():
    """A restart's model (other weights) gets a program of its own: the
    scalars are the reference's on the new weights, the old program is
    dropped, and the hook does not keep the old model alive."""
    jcfg, tcfg = _configs()
    sd_a, sd_b = _weights(tcfg, 1), _weights(tcfg, 2)
    model_a = _model(tcfg, sd_a)
    hook = make_training_eval_hook(tcfg, model_a)
    got_a = hook(0, types.SimpleNamespace(model=model_a), None)
    old_program, old_model = weakref.ref(hook.program), weakref.ref(model_a)
    del model_a
    gc.collect()
    assert old_model() is None  # the hook holds its model weakly

    model_b = _model(tcfg, sd_b)
    got_b = hook(1, types.SimpleNamespace(model=model_b), None)
    gc.collect()
    assert old_program() is None and hook.program is not None
    _assert_close(got_b, _reference_scalars(jcfg, sd_b))
    assert got_b["eval/abs_rel"] != got_a["eval/abs_rel"]

    # an in-place load (a resume) keeps the parameters' addresses: the
    # program stays, and reads the loaded weights
    program = hook.program
    model_b.load_state_dict(sd_a)
    got = hook(2, types.SimpleNamespace(model=model_b), None)
    assert hook.program is program
    for k, v in got_a.items():
        assert got[k] == pytest.approx(v, rel=1e-6, abs=1e-12), k
