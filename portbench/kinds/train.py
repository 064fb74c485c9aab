"""Training traffic: one ``colvo_torch.runtime.loop.train`` call.

Parameters (``traffic/<name>.json``): ``sequences`` × ``frames`` rendered
frames as the corpus, each sequence lit by a ``gain`` drawn from its range
and each frame by an exposure ``jitter``, ``warm_steps`` steps before the rate is taken over
``calibrate_steps`` more, ``trace_steps`` traced after the window, and
``overrides`` of the configuration (the loader: ``data.loader``).

The loop runs as a user's ``cli train`` does, with the benchmark's weights
(made from the seed) put into its freshly built state and its step
function wrapped from outside (``runtime.loop.make_step_fn``): the wrapper
copies what the check needs from the first three steps (their batches and
loss terms, Adam's first moment after step 1, the weights after step 3),
synchronises before step ``warm_steps`` and again ``calibrate_steps``
later, which opens the window, sizes the window to ``--seconds`` at the
rate between the two, and synchronises after its last step, which closes
it. The loop then stops by an exception from the wrapper, before it
would write its final checkpoint; the eval hook is not given. So the
window holds steady-state steps only: the step's capture, the first
batches and the loader's start are set-up.
"""

from __future__ import annotations

import tempfile
import time
from unittest import mock

import numpy as np
import torch

from portbench import render, weights
from portbench.harness import Ctx, Outcome, free, sync
from portbench.reference import data as ref_data
from portbench.reference import train as ref_train
from portbench.reference.quant import fp8

CHECKED = 3  # steps the reference follows


class WindowClosed(Exception):
    """Raised by the step wrapper to end the loop after the window."""


class Stepper:
    """The wrapper around the loop's step function (see the module's docstring)."""

    def __init__(self, ctx: Ctx, step_fn):
        self.ctx, self.step_fn = ctx, step_fn
        self.warm = int(ctx.param("warm_steps"))
        self.cal = int(ctx.param("calibrate_steps"))
        self.calls = 0
        self.batches, self.losses = [], []
        self.mu1 = self.theta = None
        self.t_cal = self.t0 = self.t1 = None
        self.n_window = None
        self.profiled = None
        self.trace = None
        self.last_loss = self.final_loss = self.t_first = None

    def _now(self) -> float:
        sync(self.ctx.device)
        return time.perf_counter()

    def __call__(self, state, batch):
        i, ctx = self.calls, self.ctx
        if ctx.seconds <= 0 and i == CHECKED:
            raise WindowClosed  # readings only: no window
        if i < CHECKED:
            self.batches.append({k: batch[k].clone() for k in ("frames", "frames_clean", "k")})
        if ctx.seconds > 0:
            self._window(i)
        metrics = self.step_fn(state, batch)
        if i == 0:
            self.t_first = time.perf_counter()
        if i < CHECKED:
            self.losses.append({k: v.detach().clone() for k, v in metrics.items()
                                if k.startswith("loss/")})
        if i == 0:
            opt = state.optimizer
            self.mu1 = {n: opt.state[p]["exp_avg"].detach().float().clone()
                        for n, p in state.model.named_parameters()}
        if i == CHECKED - 1:
            self.theta = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        self.last_loss = metrics["loss/total"]
        self.calls += 1
        return metrics

    def _window(self, i: int) -> None:
        open_at = self.warm + self.cal
        if i == self.warm:
            self.t_cal = self._now()
        elif i == open_at:
            self.t0 = self._now()
            per_step = (self.t0 - self.t_cal) / self.cal
            self.n_window = max(int(round(self.ctx.seconds / per_step)), 1)
        elif self.n_window is not None and i == open_at + self.n_window:
            self.t1 = self._now()
            self.final_loss = float(self.last_loss)
            if not (self.ctx.trace and self.ctx.device.type == "cuda"):
                raise WindowClosed
            from portbench.trace import Profiled

            self.profiled = Profiled(self.ctx.device).__enter__()
        elif (self.profiled is not None
              and i == open_at + self.n_window + int(self.ctx.param("trace_steps"))):
            self.profiled.__exit__(None, None, None)
            self.trace = self.profiled.trace
            raise WindowClosed


def corpus(ctx: Ctx, cfg):
    """The rendered corpus: (uint8 sequences on the device, the dataset)."""
    from colvo_torch.data import SnippetDataset

    h, w = cfg.data.height, cfg.data.width
    seqs = render.corpus(int(ctx.param("sequences")), int(ctx.param("frames")), h, w,
                         ctx.seed, ctx.device, ctx.param("gain"), float(ctx.param("jitter")))
    host = [s.cpu().numpy().astype(np.float32) / 255.0 for s in seqs]
    k = render.intrinsics(h, w)
    return seqs, SnippetDataset(host, [k] * len(host), cfg.data.frame_offsets)


def run(ctx: Ctx) -> Outcome:
    from colvo_torch.runtime import loop

    cfg = ctx.colvo_config()
    marks = [("start", time.perf_counter())]
    seqs, dataset = corpus(ctx, cfg)
    marks.append(("render", time.perf_counter()))
    w = weights.make(cfg.model, ctx.seed, ctx.device)
    sync(ctx.device)
    marks.append(("weights", time.perf_counter()))
    real_init, real_make = loop.init_state, loop.make_step_fn
    holder = {}

    def init_state(cfg_, seed=None, device="cuda", steps_per_epoch=1000):
        state = real_init(cfg_, seed=seed, device=device, steps_per_epoch=steps_per_epoch)
        state.model.load_state_dict(w)
        return state

    def make_step_fn(state, cfg_):
        holder["stepper"] = Stepper(ctx, real_make(state, cfg_))
        return holder["stepper"]

    with tempfile.TemporaryDirectory() as tmp:
        cfg.train.ckpt_dir = f"{tmp}/ckpt"
        with mock.patch.object(loop, "init_state", init_state), \
                mock.patch.object(loop, "make_step_fn", make_step_fn):
            try:
                loop.train(cfg, dataset, log_dir=f"{tmp}/log", max_steps=10**9,
                           device=ctx.device)
            except WindowClosed:
                pass
    st = holder.pop("stepper")
    st.step_fn = None
    sync(ctx.device)
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    free(ctx.device)

    steps_per_epoch = len(dataset) // cfg.data.batch_size
    e2e, attempted, failed = {}, 0, 0
    if ctx.seconds > 0:
        marks += [("loop start and first step (capture)", st.t_first),
                  ("warm steps", st.t_cal), ("steps that size the window", st.t0)]
        attempted = st.n_window
        failed = 0 if np.isfinite(st.final_loss) else attempted
        e2e["train_step_ms"] = 1e3 * (st.t1 - st.t0) / st.n_window
        e2e["setup_s"] = st.t0 - ctx.t_start
    numbers, readings = check(ctx, cfg, st, seqs, dataset, w, steps_per_epoch)
    layer = {"step_ms": e2e.get("train_step_ms"),
             "trace_steps": int(ctx.param("trace_steps")), "cfg": cfg, "setup": marks}
    return Outcome(e2e, attempted, failed, numbers, peak, readings, st.trace, layer)


def reference_batches(ctx: Ctx, cfg, seqs, dataset) -> list:
    table = ref_data.snippet_table([len(s) for s in seqs], cfg.data.frame_offsets)
    k = torch.from_numpy(dataset.intrinsics[0]).to(ctx.device)
    if cfg.data.loader == "device":
        out = ref_data.device_batches(torch.cat(seqs), table, cfg.data, ctx.seed, CHECKED)
    elif cfg.data.loader == "numpy":
        out = [{key: torch.from_numpy(v).to(ctx.device) for key, v in b.items()}
               for b in ref_data.numpy_batches(dataset.sequences, table, cfg.data, ctx.seed,
                                               CHECKED)]
    else:
        raise NotImplementedError(f"no reference for data.loader={cfg.data.loader!r}")
    for b in out:
        b["k"] = k
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def gaps(run_out: dict, ref: dict, keep) -> dict:
    """The numbers of one side (the program, the control or a fault) against
    the reference's three steps: each step's loss, the first step's
    photometric, smoothness and geometric terms, and the worst and the
    median leaf's gap of the first gradient's norm and of the change's."""
    out = {}
    for t, (a, b) in enumerate(zip(run_out["losses"], ref["losses"]), start=1):
        out[f"loss_gap.{t}"] = _rel(a["loss/total"], b["loss/total"])
    for term in ("photometric", "smoothness", "geometric"):
        a, b = run_out["losses"][0][f"loss/{term}"], ref["losses"][0][f"loss/{term}"]
        out[f"{term}_gap.1"] = _rel(a, b)
    for name, key in (("grad", "grad"), ("change", "delta")):
        out[f"{name}_gap"] = ref_train.leaf_gap(run_out[key], ref[key], keep)[0]
        out[f"{name}_gap.median"] = ref_train.leaf_gap(run_out[key], ref[key], keep,
                                                       median=True)[0]
    return out


def check(ctx: Ctx, cfg, st: Stepper, seqs, dataset, w, steps_per_epoch) -> tuple:
    """The program's numbers against the reference, and the calibration's
    readings (``ctx.readings``): the float8 control and the half-batch
    fault in the program's place."""
    batches = reference_batches(ctx, cfg, seqs, dataset)
    batch_gap = max(float((p[key] - r[key]).abs().max())
                    for p, r in zip(st.batches, batches) for key in ("frames", "frames_clean"))
    ref = ref_train.steps(w, batches, cfg, steps_per_epoch)
    keep = ref_train.moving_leaves(ref["grad"])
    prog = {"losses": [{k: float(v) for k, v in m.items()} for m in st.losses],
            "grad": {n: m / (1.0 - ref_train.B1) for n, m in st.mu1.items()},
            "delta": {n: st.theta[n] - w[n] for n in w}}
    numbers = {"batch_gap": batch_gap, **gaps(prog, ref, keep)}

    readings = {}
    if "control" in ctx.readings:
        low = [{k: (v.to(torch.bfloat16).float() if k != "k" else v) for k, v in b.items()}
               for b in batches]
        readings["control"] = {
            "batch_gap": max(float((a[k] - b[k]).abs().max()) for a, b in zip(low, batches)
                             for k in ("frames", "frames_clean")),
            **gaps(ref_train.steps(w, low, cfg, steps_per_epoch, quant=fp8), ref, keep)}
    if "half" in ctx.readings:
        readings["half"] = {"batch_gap": 0.0,
                            **gaps(ref_train.steps(w, batches, cfg, steps_per_epoch, half=True),
                                   ref, keep)}
    return numbers, readings
