"""Kernel A's module (``colvo_torch/kernels/adam.py``) on the CPU: the plain
path is the foreach chain ``Adam.step`` and the clip ran before kernel A,
bit for bit; the wrappers refuse what the kernel cannot take; the flat
layout of the quads covers every element of every tensor once, for the
training models' parameter lists."""

import gc
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from colvo_torch.config import ColvoConfig
from colvo_torch.kernels import adam
from colvo_torch.models import ColVOModel
from colvo_torch.runtime.optim import Adam
from colvo_torch.runtime.train_step import clip_by_global_norm

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ("colvo_r18_gn", "colvo_dav2_vitl", "colvo_mpvit_s")


def _old_step(params, grads, mus, nus, steps, lr, betas, eps, weight_decay, mu_dtype):
    """``Adam.step``'s body before kernel A, as it was."""
    b1, b2 = betas
    torch._foreach_add_(steps, 1.0)
    mu = torch._foreach_mul(grads, 1.0 - b1)
    b1_mu = float(torch.tensor(b1, dtype=mu_dtype))
    torch._foreach_add_(mu, [m.float() for m in torch._foreach_mul(mus, b1_mu)])
    torch._foreach_mul_(nus, b2)
    torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
    t = steps[0].to(params[0].device)
    bc1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, b2), t)
    denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    if weight_decay:
        torch._foreach_add_(upd, torch._foreach_mul(params, weight_decay))
    torch._foreach_mul_(upd, -lr if not isinstance(lr, torch.Tensor) else torch.neg(lr))
    torch._foreach_add_(params, upd)
    torch._foreach_copy_(mus, mu)


def _old_clip(grads, max_norm):
    """``clip_by_global_norm`` before kernel A, as it was."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def _model_numels(name):
    """The parameter sizes of a benchmark configuration's model, on the meta
    device."""
    cfg = ColvoConfig()
    overrides = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    cfg.apply_overrides([f"{k}={json.dumps(v)}" for k, v in overrides["overrides"].items()])
    with torch.device("meta"):
        model = ColVOModel(cfg.model)
    return [p.numel() for p in model.parameters()]


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
@pytest.mark.parametrize("lr_tensor", [False, True])
def test_plain_path_is_the_old_chain_bit_for_bit(mu_dtype, weight_decay, lr_tensor):
    """Three steps of ``Adam`` on the CPU against the old foreach chain on
    copies: parameters, μ, ν and step counts equal bit for bit after each
    step, with a float and with a tensor learning rate."""
    rng = np.random.default_rng(7)
    shapes = [(1,), (3, 5), (7,), (4, 4, 2), (33,)]
    p0 = [torch.tensor(rng.normal(size=s), dtype=torch.float32) for s in shapes]
    lr = torch.tensor(3e-3) if lr_tensor else 3e-3
    params = [p.clone().requires_grad_(True) for p in p0]
    opt = Adam(params, lr=lr, weight_decay=weight_decay, mu_dtype=mu_dtype,
               capturable=lr_tensor)
    ref = [p.clone() for p in p0]
    mus = [torch.zeros_like(p, dtype=mu_dtype) for p in p0]
    nus = [torch.zeros_like(p) for p in p0]
    steps = [torch.zeros((), dtype=torch.float32) for _ in p0]
    for _ in range(3):
        grads = [torch.tensor(rng.normal(size=s), dtype=torch.float32) for s in shapes]
        for p, g in zip(params, grads):
            p.grad = g.clone()
        opt.step()
        _old_step(ref, grads, mus, nus, steps, lr, (0.9, 0.999), 1e-8, weight_decay, mu_dtype)
        for i, p in enumerate(params):
            st = opt.state[p]
            assert torch.equal(p.detach(), ref[i])
            assert st["exp_avg"].dtype == mu_dtype and torch.equal(st["exp_avg"], mus[i])
            assert torch.equal(st["exp_avg_sq"], nus[i]) and torch.equal(st["step"], steps[i])


@pytest.mark.parametrize("max_norm", [1e-3, 1e6])
def test_plain_clip_is_the_old_chain_bit_for_bit(max_norm):
    """The clip on the CPU scales in place and returns the norm, as the old
    chain did, bit for bit, engaged and not."""
    rng = np.random.default_rng(3)
    grads = [torch.tensor(rng.normal(size=s), dtype=torch.float32) for s in [(5,), (2, 3), (1,)]]
    want = [g.clone() for g in grads]
    norm = clip_by_global_norm(grads, max_norm)
    assert torch.equal(norm, _old_clip(want, max_norm))
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def test_wrappers_refuse_mixed_devices_non_dense_tensors_and_unequal_strides():
    """Tensors on two devices, a strided view, and a gradient whose strides
    differ from its parameter's are refused before any pass runs, by both
    entry points; a device other than the CPU and CUDA is refused too."""
    p = [torch.zeros(4, 6), torch.zeros(3)]
    mus, nus, steps = [torch.zeros_like(t) for t in p], [torch.zeros_like(t) for t in p], [
        torch.zeros(()) for _ in p]
    args = (1e-3, (0.9, 0.999), 1e-8, 0.0)
    on_meta = [torch.zeros(4, 6, device="meta"), torch.zeros(3)]
    strided = [torch.zeros(4, 12)[:, ::2], torch.zeros(3)]
    transposed = [torch.zeros(6, 4).t(), torch.zeros(3)]
    for grads in (on_meta, strided, transposed):
        with pytest.raises(ValueError):
            adam.adam_update(p, grads, mus, nus, steps, *args, plans=adam.Plans())
    for grads in (on_meta, strided):
        with pytest.raises(ValueError):
            adam.clip_global_norm(grads, 1.0)
    meta = [torch.zeros(4, device="meta")]
    with pytest.raises(ValueError, match="CUDA"):
        adam.clip_global_norm(meta, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        adam.adam_update(meta, meta, meta, meta, [torch.zeros((), device="meta")], *args,
                         plans=adam.Plans())
    # a dense tensor in another memory order than its row-major one is taken
    q = [torch.zeros(6, 4).t()]
    adam.adam_update(q, [torch.ones(6, 4).t()], [torch.zeros(6, 4).t()],
                     [torch.zeros(6, 4).t()], [torch.zeros(())], *args, plans=adam.Plans())
    assert torch.isfinite(q[0]).all() and bool((q[0] != 0).all())


@pytest.mark.parametrize("name", CONFIGS + ("mixed",))
def test_layout_covers_every_element_once(name):
    """Each tensor's quads follow the last one's, ceil(numel/4) of them, so
    every element has one quad and one place in it, the padding lies past
    each tensor's end, and the chunks cover the quads: for the training
    models' lists (160, 470 and 742 tensors) and one with empty and
    1-element tensors."""
    numels = ([0, 1, 5, 0, 4, 3, 4096 * 3 + 1, 0, 1] if name == "mixed"
              else _model_numels(name))
    qoff, n_chunks = adam.layout(numels)
    assert len(qoff) == len(numels) + 1 and qoff[0] == 0
    seen = 0
    for i, n in enumerate(numels):
        quads = qoff[i + 1] - qoff[i]
        assert 4 * quads >= n > 4 * (quads - 1) or (n == 0 and quads == 0)
        seen += n
    assert seen == sum(numels)
    assert (n_chunks - 1) * adam.CHUNK_QUADS < qoff[-1] <= n_chunks * adam.CHUNK_QUADS


def test_plans_key_keep_and_share_tables(monkeypatch):
    """``Plans`` keys a table by each tensor's address, device, dtype, shape
    and strides (a list at the same addresses in another dtype or strides
    gets a table of its own); it keeps the ``RECENT`` used last and, for its
    own life, each that a capture read, but none built inside a capture;
    the clip's index finds the table that holds its gradients while its
    ``Plans`` holds it, and nothing after."""
    built = []

    class Stub:
        """``Plan`` without a table (nothing is launched)."""

        use = adam.Plan.use

        def __init__(self, arrays, device):
            self.captured = False
            built.append(self)

    capturing = [False]
    monkeypatch.setattr(adam, "Plan", Stub)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    buf, dev = torch.zeros(64), torch.device("cpu")

    def get(plans, g):
        return plans.get((None, [g], None, None, None), dev)

    plans = adam.Plans()
    a = get(plans, buf[:32].view(4, 8))
    assert get(plans, buf[:32].view(4, 8)) is a and len(built) == 1
    assert get(plans, buf[:32].view(8, 4).t()) is not a  # the same shape, other strides
    assert get(plans, buf[:32].view(torch.int32).view(4, 8)) is not a  # another dtype
    capturing[0] = True
    assert get(plans, buf[:32].view(4, 8)) is a and a.captured
    inside = get(plans, buf[1:9])
    capturing[0] = False
    others = [get(plans, buf[i:i + 8]) for i in range(2, 2 + 2 * adam.Plans.RECENT)]
    assert get(plans, buf[1 + 2 * adam.Plans.RECENT:9 + 2 * adam.Plans.RECENT]) is others[-1]
    assert get(plans, buf[:32].view(4, 8)) is a  # a capture read it: kept
    assert get(plans, buf[1:9]) is not inside  # built inside the capture: not kept
    assert get(plans, buf[2:10]) is not others[0]  # fell out of the recent ones
    held = get(plans, buf[40:48])
    assert adam._BY_GRADS.get(adam._key([buf[40:48]])) is held
    assert adam._BY_GRADS.get(adam._key([buf[41:49]])) is None
    del plans, held, a, inside, others, built[:]
    gc.collect()
    assert adam._BY_GRADS.get(adam._key([buf[40:48]])) is None
