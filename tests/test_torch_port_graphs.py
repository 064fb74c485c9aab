"""colvo_torch's captured programs (``runtime/graphs.py``) on the CPU: the
helper's buffer semantics and signature keys, and every program of the
port through it against the reference's jitted function on the same
inputs: ``InferenceRunner``'s three functions, ``StreamingVO``'s init and
chunk steps, ``make_train_step`` and the loop that calls it, and
keyframe refinement. On the CPU a program copies its inputs into static
buffers, runs its body eagerly on them and copies the results into static
outputs, as a replay on the card overwrites them, so a caller that keeps
an output too long fails here too."""

import json
import math
import os
from unittest import mock

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import colvo.losses.total as jax_total
import colvo.vo.refine as jax_refine
import colvo_torch.losses.total as port_total
import colvo_torch.runtime.loop as port_loop
from colvo.config import ColvoConfig as JaxConfig
from colvo.data.synthetic import default_intrinsics, make_trajectory, render_frame
from colvo.models import ColVOModel as JaxModel
from colvo.runtime.infer import InferenceRunner as JaxRunner
from colvo.runtime.train_step import TrainState as JaxState
from colvo.runtime.train_step import make_optimizer
from colvo.runtime.train_step import make_train_step as jax_make_train_step
from colvo.vo.stream import StreamingVO as JaxStreamingVO
from colvo_torch import cli
from colvo_torch.config import ColvoConfig
from colvo_torch.data import SnippetDataset, batch_iterator, render_sequence
from colvo_torch.models import ColVOModel
from colvo_torch.runtime import (InferenceRunner, flax_params, init_state, make_train_step,
                                 params_from_flax, to_device, train_step)
from colvo_torch.runtime.graphs import Graphed
from colvo_torch.runtime.mesh import Mesh
from colvo_torch.runtime.train_step import TrainStep
from colvo_torch.vo import StreamingVO, refine
from colvo_torch.vo.stream import _chunk_body, _init_body, rgb_to_i420
from test_torch_port_train_step import SharedAutomask, _flax_tree

torch.set_num_threads(2)

H, W = 64, 96
N_FRAMES, CHUNK = 7, 3  # 7 frames: the last chunk of 3 is padded


# --- the helper -----------------------------------------------------------


def test_a_held_output_is_overwritten_by_the_next_call_and_a_copy_is_not():
    prog = Graphed(lambda x, y: {"sum": x + y, "prod": x * y})
    rng = np.random.default_rng(0)
    a, b, c = (torch.from_numpy(rng.random((2, 3), dtype=np.float32)) for _ in range(3))
    first = prog(a, b)
    kept = {k: v.clone() for k, v in first.items()}
    second = prog(a, c)
    # the same static outputs, in fresh containers
    assert second is not first and second["sum"] is first["sum"]
    torch.testing.assert_close(first["sum"], a + c, rtol=0, atol=0)
    torch.testing.assert_close(kept["sum"], a + b, rtol=0, atol=0)
    torch.testing.assert_close(kept["prod"], a * b, rtol=0, atol=0)
    # the inputs were copied: changing the caller's tensor changes nothing
    a.zero_()
    torch.testing.assert_close(second["prod"], kept["prod"] / b * c, rtol=1e-6, atol=0)


def test_programs_are_keyed_by_shape_dtype_structure_and_static_values():
    calls = []

    def body(x, scale=1.0, extra=()):
        calls.append(1)
        return x * scale + sum(extra)

    prog = Graphed(body)
    x = torch.ones(2, 3)
    prog(x)
    prog(x + 1)
    assert len(prog.programs) == 1 and len(calls) == 2  # the same signature: reused
    prog(torch.ones(4, 3))
    prog(x.double())
    prog(x, scale=2.0)
    prog(x, extra=(torch.ones(()),))
    assert len(prog.programs) == 5
    prog(torch.ones(4, 3) * 3)
    assert len(prog.programs) == 5
    np.testing.assert_array_equal(prog(x, scale=2.0).numpy(), np.full((2, 3), 2.0))


def test_a_body_that_changes_its_output_structure_raises():
    flip = []

    def body(x):
        flip.append(1)
        return (x,) if len(flip) == 1 else (x, x)

    prog = Graphed(body)
    prog(torch.zeros(2))
    with pytest.raises(ValueError, match="structure"):
        prog(torch.zeros(2))


# --- serving ----------------------------------------------------------------


def _configs():
    jcfg, tcfg = JaxConfig(), ColvoConfig()
    jcfg.model.dtype = tcfg.model.dtype = "float32"
    jcfg.data.height = tcfg.data.height = H
    jcfg.data.width = tcfg.data.width = W
    return jcfg, tcfg


@pytest.fixture(scope="module")
def runners():
    """(reference runner, port runner) over the same random weights, every
    parameter away from its init value."""
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in ColVOModel(tcfg.model).state_dict().items():
        if v.ndim == 4:
            a = rng.normal(0, 1 / math.sqrt(v[0].numel()), v.shape)
        elif "norm" in k and k.endswith("weight"):
            a = 1 + 0.1 * rng.normal(size=v.shape)
        else:
            a = 0.05 * rng.normal(size=v.shape)
        sd[k] = torch.tensor(a, dtype=torch.float32)
    flat = flax_params(sd)
    ref = JaxRunner(jcfg, flax.traverse_util.unflatten_dict(flat, sep="/"))
    return ref, InferenceRunner(tcfg, params_from_flax(flat), device="cpu")


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(3).random((N_FRAMES, H, W, 3), dtype=np.float32)


def test_runner_programs_match_the_reference_at_two_batch_shapes(runners, frames):
    """``infer_depth``, ``infer_pose`` and ``infer_coupled`` at B=2, then
    B=1 (a program each), against the reference's jitted ``_depth``,
    ``_pose`` and ``_coupled`` at ``test_torch_port_models.py``'s bounds;
    the arrays of the first call are the caller's own and survive the
    second."""
    ref, port = runners
    a2, b2 = frames[:2], frames[1:3]
    got2 = port.infer_coupled(a2, b2)
    kept = [g.copy() for g in got2]
    for n, (a, b) in ((2, (a2, b2)), (1, (frames[4:5], frames[5:6]))):
        got, want = port.infer_coupled(a, b), ref.infer_coupled(a, b)
        for g, w in zip(got, want):
            assert g.shape[0] == n
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(port.infer_pose(a, b), ref.infer_pose(a, b), atol=1e-6)
        depth, disp = port.infer_depth(a)
        want_depth, want_disp = ref.infer_depth(a)
        np.testing.assert_allclose(depth, want_depth, rtol=1e-4)
        np.testing.assert_allclose(disp, want_disp, rtol=1e-4, atol=1e-6)
    for g, k in zip(got2, kept):
        np.testing.assert_array_equal(g, k)
    from colvo_torch.runtime.infer import _coupled_body, _depth_body, _pose_body
    for body in (_coupled_body, _pose_body, _depth_body):
        assert len(port.program(body).programs) == 2


def _u8(frames):
    return np.clip(frames * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _inputs(frames, kind):
    return {
        "f32": (frames, "rgb"),
        "u8": (_u8(frames), "rgb"),
        "i420": (rgb_to_i420(_u8(frames)), "i420"),
        "i420full": (rgb_to_i420(_u8(frames), video_range=False), "i420full"),
    }[kind]


@pytest.mark.parametrize("kind,wire,symmetric", [
    ("f32", "float32", False), ("u8", "float32", False), ("i420", "float32", False),
    ("i420full", "float32", False), ("u8", "float16", False), ("u8", "uint8", False),
    ("i420", "float16", True),
])
def test_stream_through_its_programs_matches_the_reference(runners, frames, kind, wire,
                                                            symmetric):
    """``StreamingVO.run`` over 7 frames in chunks of 3 (the last padded),
    its init and chunk steps one program each, against the reference's
    jitted ``init_fn`` and ``chunk_fn``: float32 depths to rtol 1e-4 /
    atol 1e-5, float16 within one float16 ulp of the reference's, uint8
    disparity within one quantisation step (plus a few ulps of rounding);
    rel6 to 1e-5. The stream used exactly one program of each kind for
    this (format, wire, symmetric pose)."""
    ref, port = runners
    inputs, fmt = _inputs(frames, kind)
    kw = dict(chunk_size=CHUNK, depth_dtype=wire, input_format=fmt, symmetric_pose=symmetric)
    before = {b: set(port.program(b).programs) for b in (_init_body, _chunk_body)}
    d, p = StreamingVO(port, **kw).run(list(inputs))
    jd, jp = JaxStreamingVO(ref, **kw).run(list(inputs))
    for body in before:  # at most one new program of each kind, and one there
        progs = set(port.program(body).programs)
        assert len(progs - before[body]) <= 1 and progs
    assert len(d) == N_FRAMES and p.shape == (N_FRAMES - 1, 6)
    np.testing.assert_allclose(p, jp, rtol=0, atol=1e-5)
    d, jd = np.stack(d), np.stack(jd)
    if wire == "float32":
        np.testing.assert_allclose(d, jd, rtol=1e-4, atol=1e-5)
    elif wire == "float16":
        assert np.all(np.abs(d - jd) <= np.spacing(jd.astype(np.float16)).astype(np.float32))
    else:
        for got, want in zip(d[1:], jd[1:]):
            disp, jdisp = 1.0 / got, 1.0 / want
            step = (jdisp.max() - jdisp.min()) / 255.0
            assert np.abs(disp - jdisp).max() <= step + 4 * np.spacing(jdisp.max())


def test_a_fetched_wire_is_not_overwritten_by_the_next_chunk(runners, frames):
    """The wire each chunk hands its fetch thread stays as it was decoded
    after every later chunk has run (the program's static output is
    overwritten; the fetch reads a copy), and each equals the wire of the
    chunk's eager body."""
    _, port = runners
    inputs, _ = _inputs(frames, "u8")
    vo = StreamingVO(port, chunk_size=CHUNK, depth_dtype="float32")
    seen = []
    real = vo.decode_wire

    def decode_wire(wire, hw):
        seen.append((wire, wire.copy()))
        return real(wire, hw)

    with mock.patch.object(vo, "decode_wire", decode_wire):
        vo.run(list(inputs))
    assert len(seen) == 2
    for held, at_fetch in seen:
        np.testing.assert_array_equal(held, at_fetch)
    assert not np.array_equal(seen[0][1], seen[1][1])
    with torch.inference_mode():
        _, ci, cb = vo.init_step(torch.from_numpy(inputs[:1]))
        ci, cb = ci.clone(), cb.clone()
        chunk = torch.from_numpy(np.stack(inputs[1:1 + CHUNK]))
        wire = vo.chunk_body(ci, cb, chunk)[0]
    np.testing.assert_array_equal(wire.numpy(), seen[0][1])


# --- training ---------------------------------------------------------------


def _train_configs():
    cfgs = JaxConfig(), ColvoConfig()
    for cfg in cfgs:
        cfg.model.dtype = "float32"
        cfg.data.height, cfg.data.width, cfg.data.batch_size = H, W, 2
        cfg.data.augment = False
        # clipping active, a linear warmup and a geo ramp: each step's
        # learning rate and geo weight come from the device counter
        cfg.train.lr, cfg.train.grad_clip = 1e-4, 0.1
        cfg.train.warmup_steps, cfg.loss.geo_ramp_steps = 2, 3
    return cfgs


def test_make_train_step_tracks_the_references_make_train_step():
    """Three ``make_train_step`` steps from the port's weights at each step,
    against ``colvo``'s jitted ``make_train_step`` on the same weights and
    batches (the reference's automask decisions shared): the loss, every
    aux term and grad_norm to 1e-3 relative, and the port's update equal
    to optax's warmup + clip + Adam update of the port's own gradients to
    1e-3 of the learning rate (``test_three_adam_steps_track_reference``'s
    bounds and batch: one batch, three steps). The warmup makes step 1's
    update zero, so a counter off by one shows. An eager ``train_step`` run
    from the same weights gives the same metrics and weights bit for bit."""
    jcfg, tcfg = _train_configs()
    shared = SharedAutomask(tcfg.model.n_scales)
    seq = render_sequence(n_frames=6, height=H, width=W)
    ds = SnippetDataset([seq.frames], [seq.k], tcfg.data.frame_offsets)
    batches = [next(batch_iterator(ds, tcfg.data, seed=0))] * 3
    state = init_state(tcfg, seed=3, device="cpu")
    eager = init_state(tcfg, seed=3, device="cpu")
    step_fn = make_train_step(state, tcfg)
    model = state.model
    tx = make_optimizer(jcfg)
    opt_state = tx.init(_flax_tree(model.state_dict()))
    update = jax.jit(tx.update)
    with mock.patch.object(jax_total, "automask_fn", shared.jax_automask), \
            mock.patch.object(port_total, "automask_fn", shared.port_automask):
        jax_step = jax_make_train_step(JaxModel(jcfg.model), tx, jcfg)
        for step, batch in enumerate(batches):
            before = {k: v.clone() for k, v in model.state_dict().items()}
            # the reference's step donates its state: it gets copies
            jstate = JaxState(_flax_tree(before), jax.tree_util.tree_map(jnp.array, opt_state),
                              jnp.asarray(step, jnp.int32))
            _, jm = jax_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
            jax.effects_barrier()
            masks = dict(shared.masks)
            m = step_fn(state, to_device(batch, torch.device("cpu")))
            shared.masks = masks  # the eager step takes the same decisions
            m_eager = train_step(eager, to_device(batch, torch.device("cpu")), tcfg)
            for k, v in m_eager.items():
                assert torch.equal(m[k], v), (k, step)
            for k, v in jm.items():
                np.testing.assert_allclose(m[k].item(), float(v), rtol=1e-3, atol=1e-7,
                                           err_msg=f"{k} at step {step}")
            norm = m["grad_norm"].item()
            assert norm > tcfg.train.grad_clip
            grads = {n: p.grad * (norm / tcfg.train.grad_clip) for n, p in model.named_parameters()}
            updates, opt_state = update(_flax_tree(grads), opt_state)
            want = params_from_flax(flax.traverse_util.flatten_dict(updates, sep="/"))
            for name, p in model.named_parameters():
                moved = (p.detach() - before[name]).numpy()
                if step == 0:
                    assert not moved.any(), name
                np.testing.assert_allclose(moved, want[name].numpy(), rtol=0,
                                           atol=1e-3 * tcfg.train.lr, err_msg=name)
    assert state.step == 3 and int(step_fn.step) == 2
    for p, q in zip(model.parameters(), eager.model.parameters()):
        assert torch.equal(p, q)
    shared.check_port_decisions()


def _tiny(tmp_path):
    cfg = ColvoConfig()
    cfg.model.dtype = "float32"
    cfg.model.n_scales = 2
    cfg.data.height, cfg.data.width = H, W
    cfg.data.frame_offsets = (1,)
    cfg.data.batch_size = 2
    cfg.data.augment = False
    cfg.train.lr = 3e-4
    cfg.train.log_every = 1
    cfg.train.ckpt_dir = str(tmp_path / "ckpt")
    return cfg


def _dataset():
    seq = render_sequence(n_frames=8, height=H, width=W, seed=3)
    return SnippetDataset([seq.frames], [seq.k], (1,))


def _rows(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _eager_metrics(cfg, batches, seed=None, steps_per_epoch=1000):
    """Eager ``train_step`` calls from a fresh state on ``batches``: each
    step's metrics as floats."""
    state = init_state(cfg, seed=seed, device="cpu", steps_per_epoch=steps_per_epoch)
    return [{k: float(v) for k, v in train_step(state, to_device(b, torch.device("cpu")),
                                                  cfg).items()} for b in batches]


def _step_rows(rows):
    return [r for r in rows if "loss/total" in r]


def test_cli_train_logs_each_steps_own_metrics(tmp_path):
    """``cli train`` with ``log_every=1``: every row holds its own step's
    metrics, the values of eager ``train_step`` calls from the same state
    on the same batches, bit for bit (the step's static outputs are copied
    before the next replay overwrites them)."""
    cfg = _tiny(tmp_path)
    ds = _dataset()
    args = ["train", "--device", "cpu", "--max-steps", "4", "--log-dir", str(tmp_path / "log"),
            f"--train.ckpt_dir={tmp_path / 'ckpt'}", f"--data.height={H}", f"--data.width={W}",
            "--data.batch_size=2", "--model.dtype=float32", "--model.n_scales=2",
            "--data.frame_offsets=[1]", "--data.augment=false", "--train.log_every=1",
            "--train.lr=3e-4", "--train.eval_every_epochs=0"]
    with mock.patch("colvo_torch.pipelines.build_dataset", lambda cfg_: ds):
        assert cli.main(args) == 0
    rows = _step_rows(_rows(tmp_path / "log"))
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    it = batch_iterator(ds, cfg.data, seed=cfg.train.seed)
    want = _eager_metrics(cfg, [next(it) for _ in range(4)],
                          steps_per_epoch=len(ds) // cfg.data.batch_size)
    for r, w in zip(rows, want):
        assert {k: r[k] for k in w} == w, r["step"]


def test_a_basin_restart_takes_a_new_program_on_the_new_state(tmp_path):
    """A restart at step 3 (``log_every=1``): the restart's metric value is
    step 3's own loss; the attempts' rows equal eager steps from the first
    state on batches 1-3 and from the reseeded one on batches 4-6."""
    cfg = _tiny(tmp_path)
    cfg.train.restart_metric = "loss/total"
    cfg.train.restart_threshold = 1e-9  # always trips at the check step
    cfg.train.restart_check_step = 3
    cfg.train.restart_max = 1
    ds = _dataset()
    made = []
    real_make = port_loop.make_step_fn

    def make_step_fn(state, cfg_):
        made.append(real_make(state, cfg_))
        return made[-1]

    with mock.patch.object(port_loop, "make_step_fn", make_step_fn):
        _, state = port_loop.train(cfg, ds, log_dir=str(tmp_path / "log"), max_steps=3,
                                   device="cpu")
    assert len(made) == 2 and all(isinstance(m, TrainStep) for m in made)
    assert made[1].state is state and made[0].state is not state
    rows = _rows(tmp_path / "log")
    restart = [r for r in rows if "restart/attempt" in r]
    steps = _step_rows(rows)
    assert [r["step"] for r in steps] == [1, 2, 3, 1, 2, 3]
    assert restart[0]["restart/metric_value"] == steps[2]["loss/total"]
    it = batch_iterator(ds, cfg.data, seed=cfg.train.seed)
    batches = [next(it) for _ in range(6)]
    spe = len(ds) // cfg.data.batch_size
    want = (_eager_metrics(cfg, batches[:3], steps_per_epoch=spe)
            + _eager_metrics(cfg, batches[3:], seed=cfg.train.seed + 1000, steps_per_epoch=spe))
    for r, w in zip(steps, want):
        assert {k: r[k] for k in w} == w, r["step"]


def test_a_resumed_program_counts_from_the_restored_step(tmp_path):
    """Under a 4-step warmup the learning rate depends on the step: a run
    resumed from its step-2 checkpoint logs steps 3 and 4 as the straight
    4-step run does, bit for bit."""
    def run(log, max_steps, resume):
        cfg = _tiny(tmp_path)
        cfg.train.warmup_steps = 4
        cfg.train.ckpt_every_steps = 2
        cfg.train.ckpt_dir = str(tmp_path / log / "ckpt")
        port_loop.train(cfg, _dataset(), log_dir=str(tmp_path / log), max_steps=max_steps,
                        resume=resume, device="cpu")
        return _step_rows(_rows(tmp_path / log))

    straight = run("a", 4, False)
    run("b", 2, False)
    resumed = run("b", 4, True)
    assert [r["step"] for r in resumed] == [1, 2, 3, 4]
    drop = ("time", "steps_per_sec", "fps")
    for a, b in zip(straight[2:], resumed[2:]):
        assert {k: v for k, v in a.items() if k not in drop} == \
            {k: v for k, v in b.items() if k not in drop}


@pytest.mark.parametrize("case", ["mesh", "debug_nans"])
def test_a_mesh_of_two_ranks_and_debug_nans_take_the_eager_branch(tmp_path, case):
    """The loop's step under a mesh of two ranks (the loss all-reduces
    through the host) and under ``train.debug_nans`` (anomaly mode reads
    every backward output on the host) is ``train_step``, called eagerly;
    ``make_train_step`` refuses the mesh. One rank takes the program."""
    cfg = _tiny(tmp_path)
    state = init_state(cfg, device="cpu")
    state.mesh = Mesh(1, 0)
    assert isinstance(port_loop.make_step_fn(state, cfg), TrainStep)
    if case == "mesh":
        state.mesh = Mesh(2, 0)
        with pytest.raises(ValueError, match="2 ranks"):
            make_train_step(state, cfg)
    else:
        cfg.train.debug_nans = True
    step_fn = port_loop.make_step_fn(state, cfg)
    assert not isinstance(step_fn, TrainStep)
    calls = []
    with mock.patch.object(port_loop, "train_step",
                           lambda s, b, c: calls.append((s, b, c)) or {}):
        step_fn(state, {"frames": None})
    assert calls == [(state, {"frames": None}, cfg)]


# --- refinement -------------------------------------------------------------


def test_refine_program_matches_the_references_refine_jit():
    """``vo.refine._refine`` (one program: every Adam iteration and the
    keep-or-reject step) against ``colvo``'s ``_refine_jit`` on two
    perturbed keyframe pairs: refined transforms to 1e-4, the residuals to
    1e-5 relative (``tests/test_torch_port_refine.py``'s bounds); a second
    call of the same shape starts from zero again and gives the same
    result."""
    k = default_intrinsics(H, W)
    gt = make_trajectory(8, step=0.004, wobble=0.3, seed=31).astype(np.float64)
    frames, depths = [], []
    for i in (0, 2, 4):
        f, d = render_frame(gt[i], k, H, W, radius=0.03)
        frames.append(f.astype(np.float32))
        depths.append(d.astype(np.float32))
    frames, depths = np.stack(frames), np.stack(depths)
    rel = np.stack([np.linalg.inv(gt[b]) @ gt[a] for a, b in ((0, 2), (2, 4))])
    bump = np.eye(4)
    bump[:3, 3] = np.random.default_rng(1).normal(0, 1e-3, 3)
    rel = (bump @ rel).astype(np.float32)
    a = (rel, frames[:-1], frames[1:], depths[:-1], depths[1:], k.astype(np.float32))
    want = jax_refine._refine_jit(*map(jnp.asarray, a), iters=4, lr=2e-3)
    got = refine._refine(*map(torch.from_numpy, a), iters=4, lr=2e-3)
    first = [g.clone() for g in got]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        assert abs(g.item() - float(w)) <= 1e-5 * abs(float(w))
    again = refine._refine(*map(torch.from_numpy, a), iters=4, lr=2e-3)
    for f, g in zip(first, again):
        torch.testing.assert_close(g, f, rtol=0, atol=0)
