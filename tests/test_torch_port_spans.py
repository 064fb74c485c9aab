"""The span recorder (``colvo_torch.runtime.spans``): nesting across
threads, the ring's bound, recording off, the counters (the kernels' launch
counters among them), the profiler's clock, and the span trees that a pair
call, a VO stream and a training run leave on the CPU."""

import json
import sys
import threading
import time
import tracemalloc
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

from colvo_torch import kernels
from colvo_torch.kernels import build
from colvo_torch.config import ColvoConfig
from colvo_torch.data import SnippetDataset, render_sequence
from colvo_torch.models import ColVOModel
from colvo_torch.runtime import InferenceRunner, spans
from colvo_torch.runtime.loop import train as train_loop
from colvo_torch.vo.driver import run_vo

H, W = 64, 96


@pytest.fixture(autouse=True)
def recorder():
    spans.enable(True)
    spans.clear()
    spans.reset_counters()
    yield
    spans.enable(True)
    spans.clear()
    spans.reset_counters()


def _since(t_ns):
    return [s for s in spans.snapshot().spans if s.start_ns >= t_ns]


def _children(recorded):
    out = defaultdict(list)
    for s in recorded:
        out[s.parent].append(s)
    return out


def test_nesting_and_parent_ids_across_two_threads():
    both_open = threading.Barrier(2, timeout=10)

    def work(tag):
        with spans.span("outer", tag=tag):
            with spans.span("inner", tag=tag):
                both_open.wait()  # both threads hold both spans open here
            with spans.span("second", tag=tag):
                pass

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    recorded = spans.snapshot().spans
    assert len(recorded) == 6 and len({s.id for s in recorded}) == 6
    for tag in ("a", "b"):
        mine = {s.name: s for s in recorded if s.attrs == {"tag": tag}}
        assert mine["outer"].parent is None
        assert mine["inner"].parent == mine["second"].parent == mine["outer"].id
        assert len({s.thread for s in mine.values()}) == 1
        assert mine["outer"].start_ns <= mine["inner"].start_ns <= mine["inner"].end_ns \
            <= mine["second"].start_ns <= mine["outer"].end_ns
        assert not any(s.profiled for s in mine.values())
    assert len({s.thread for s in recorded}) == 2


def test_ring_is_bounded_and_drops_the_oldest_first():
    extra = 10
    for i in range(spans.RING_SIZE + extra):
        with spans.span("s", i=i):
            pass
    recorded = spans.snapshot().spans
    assert len(recorded) == spans.RING_SIZE
    assert [s.attrs["i"] for s in recorded] == list(range(extra, spans.RING_SIZE + extra))
    spans.clear()
    assert spans.snapshot() == ([], {})


def _loop_peak(fn, n=20000) -> int:
    fn(10)
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        fn(n)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after == before
    return peak - before


class _NoLock:
    def __enter__(self):
        raise AssertionError("a lock was taken")

    def __exit__(self, *exc):
        return False


def test_off_records_nothing_allocates_nothing_and_takes_no_lock(monkeypatch):
    spans.enable(False)
    monkeypatch.setattr(spans, "_counters_lock", _NoLock())
    ctx = spans.span("a", call=1, bytes=5)
    assert ctx is spans.span("b") and type(ctx).__name__ == "_Noop"
    with ctx:
        spans.count("c", 3)

    def empty(n):
        for _ in range(n):
            pass

    def calls(n):
        for _ in range(n):
            spans.span("a", call=1, bytes=5)
            spans.span("b")
            spans.count("c", 3)

    assert _loop_peak(calls) == _loop_peak(empty)
    monkeypatch.undo()
    assert spans.snapshot() == ([], {})


def test_counters_and_launch_counts_through_the_move():
    spans.count("a")
    spans.count("a", 4)
    spans.count("b.x", 2)
    assert spans.counters() == {"a": 5, "b.x": 2} and spans.counters("b.") == {"b.x": 2}
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {}
    kernels.add_launch_counts({"S/grad/C3": 2, "T/C1": 1}, times=3)
    build.count_launch("S/grad/C3")  # one launch, as a wrapper counts it
    assert kernels.launch_counts() == {"S/grad/C3": 7, "T/C1": 3}
    before = kernels.launch_counts()
    kernels.add_launch_counts({"F/fwd/C3": 2})
    # Graphed's capture: what the capture counted is the difference, put back after
    captured = dict(Counter(kernels.launch_counts()) - Counter(before))
    kernels.reset_launch_counts()
    kernels.add_launch_counts(before)
    assert captured == {"F/fwd/C3": 2} and kernels.launch_counts() == before
    assert spans.counters("launch.") == {"launch.S/grad/C3": 7, "launch.T/C1": 3}
    kernels.reset_launch_counts()
    assert spans.counters() == {"a": 5, "b.x": 2}


def test_launch_counters_count_while_off_and_outlive_clear():
    kernels.reset_launch_counts()
    spans.enable(False)
    build.count_launch("S/grad/C3")
    kernels.add_launch_counts({"T/C1": 2})  # a replay of a graph captured while off
    spans.count("off")
    spans.enable(True)
    spans.count("on")
    assert spans.counters() == {"launch.S/grad/C3": 1, "launch.T/C1": 2, "on": 1}
    spans.clear()
    assert kernels.launch_counts() == {"S/grad/C3": 1, "T/C1": 2}
    assert spans.counters() == {"launch.S/grad/C3": 1, "launch.T/C1": 2}
    kernels.reset_launch_counts()
    assert spans.counters() == {}


def test_counters_lose_no_update_across_threads():
    n_threads, n = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [spans.count("hits") for _ in range(n)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert spans.counters() == {"hits": n_threads * n}


def test_profiled_spans_export_on_the_traces_clock(tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from portbench import span_read
    from portbench.trace import Trace

    x = torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with spans.span("outer.probe", i=i):
                with spans.span("graph.replay"):  # its body stands in for the graph's launch
                    x.add_(1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = ("outer.probe", "graph.replay")
    annotations = [e for e in events if e.get("cat") == "user_annotation" and e["name"] in names]
    recorded = [s for s in spans.snapshot().spans if s.name in names]
    assert len(annotations) == len(recorded) == 6 and all(s.profiled for s in recorded)
    # the ring's spans on the trace's clock, as the readers place them
    offset, _, largest = span_read.trace_clock(Trace(events, 1.0), recorded, launch="aten::add_")
    assert largest < 1000.0
    for name in names:
        starts = sorted(e["ts"] for e in annotations if e["name"] == name)
        mine = [s.start_ns / 1e3 + offset for s in recorded if s.name == name]
        assert all(abs(a - b) < 1000.0 for a, b in zip(starts, mine)), (starts, mine)

    # no profiler: no span opens a profiler range
    def refuse(name):
        raise AssertionError("record_function called without a profiler")

    monkeypatch.setattr(spans, "record_function", refuse)
    with spans.span("plain"):
        pass
    assert not spans.snapshot().spans[-1].profiled


def _runner():
    cfg = ColvoConfig()
    cfg.model.dtype = "float32"
    cfg.model.n_scales = 2
    cfg.data.height, cfg.data.width = H, W
    torch.manual_seed(0)
    return InferenceRunner(cfg, ColVOModel(cfg.model).state_dict(), device="cpu")


def test_infer_coupled_leaves_its_span_tree():
    runner = _runner()
    frames = np.random.default_rng(0).random((2, 1, H, W, 3), dtype=np.float32)
    t_ns = time.perf_counter_ns()
    out = runner.infer_coupled(frames[0], frames[1])
    recorded = _since(t_ns)
    kids = _children(recorded)
    (call,) = kids[None]
    assert call.name == "infer.call" and call.attrs == {"call": 0}
    assert [s.name for s in kids[call.id]] == ["infer.frames", "graph.copy_in", "graph.replay",
                                              "infer.fetch"]
    copy_in, replay = kids[call.id][1:3]
    assert copy_in.attrs == {"program": "_coupled_body", "bytes": 2 * H * W * 3 * 4}
    assert replay.attrs == {"program": "_coupled_body"}
    assert kids[call.id][3].attrs == {"bytes": sum(o.nbytes for o in out)}
    runner.infer_coupled(frames[1], frames[0])
    assert [s.attrs for s in _since(t_ns) if s.name == "infer.call"] == [{"call": 0}, {"call": 1}]


def test_run_vo_of_three_chunks_leaves_its_span_tree():
    runner = _runner()
    frames = np.random.default_rng(1).integers(0, 256, (7, H, W, 3), dtype=np.uint8)
    t_ns = time.perf_counter_ns()
    result = run_vo(runner, iter(frames), chunk_size=2, depth_dtype="uint8")
    assert result.poses.shape == (7, 4, 4)
    recorded = _since(t_ns)
    kids = _children(recorded)
    main = threading.get_ident()
    top = [s for s in kids[None] if s.thread == main]
    assert [s.name for s in top] == ["vo.run", "vo.chain"]
    run = top[0]
    assert [(s.name, s.attrs) for s in kids[run.id]] == (
        [("graph.copy_in", {"program": "_init_body", "bytes": H * W * 3}),
         ("graph.replay", {"program": "_init_body"})]
        + [("vo.chunk", {"chunk": k}) for k in range(3)]
        + [("vo.drain", {"chunk": k}) for k in range(3)])  # 3 chunks in flight, drained last
    for k, chunk in enumerate(s for s in kids[run.id] if s.name == "vo.chunk"):
        assert [(s.name, s.attrs.get("chunk", s.attrs.get("program")))
                for s in kids[chunk.id]] == [
            ("vo.stage", k), ("graph.copy_in", "_chunk_body"), ("graph.replay", "_chunk_body"),
            ("vo.d2h", k)]
    decodes = [s for s in kids[None] if s.name == "vo.decode"]
    assert sorted(s.attrs["chunk"] for s in decodes) == [0, 1, 2]
    assert all(s.thread != main for s in decodes)


def test_three_training_steps_leave_their_span_tree(tmp_path):
    cfg = ColvoConfig()
    cfg.model.dtype = "float32"
    cfg.model.n_scales = 2
    cfg.data.height, cfg.data.width = H, W
    cfg.data.frame_offsets = (1,)
    cfg.data.batch_size = 2
    cfg.data.augment = False
    cfg.train.log_every = 2
    cfg.train.ckpt_dir = str(tmp_path / "ckpt")
    seq = render_sequence(n_frames=8, height=H, width=W, seed=3)
    dataset = SnippetDataset([seq.frames.copy()], [seq.k], (1,))
    t_ns = time.perf_counter_ns()
    train_loop(cfg, dataset, log_dir=str(tmp_path / "log"), max_steps=3, device="cpu")
    recorded = _since(t_ns)
    kids = _children(recorded)
    main = threading.get_ident()
    top = [(s.name, s.attrs.get("step")) for s in kids[None] if s.thread == main]
    assert top == [("loop.batch", 0), ("loop.step", 0), ("loop.batch", 1), ("loop.step", 1),
                   ("loop.log", 1), ("loop.batch", 2), ("loop.step", 2), ("loop.log", 2),
                   ("loop.ckpt", 2), ("loop.batch", 3), ("loop.drain", None)]
    for s in kids[None]:
        if s.name == "loop.step":
            assert [(c.name, c.attrs["program"]) for c in kids[s.id]] == [
                ("graph.copy_in", "train_step"), ("graph.replay", "train_step")]
        if s.name in ("loop.log", "loop.ckpt"):
            assert [c.name for c in kids[s.id]] == ["loop.drain"]
    producer = [s for s in kids[None] if s.thread != main]
    names = [s.name for s in producer if s.attrs["batch"] < 3]
    assert names == ["prefetch.build", "prefetch.stage", "prefetch.put_wait"] * 3
