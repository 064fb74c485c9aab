"""The readers of the program's spans on synthetic spans and a synthetic
trace: what each takes (the timed window's requests, not the capturing
one nor the profiled ones), and None from a program without the
recorder."""

import sys
from types import SimpleNamespace

import pytest

from colvo_torch.runtime.spans import Span
from portbench import harness, span_read
from portbench.trace import Trace

READERS = ["pair_copy_in_ms.pairs", "pair_launch_ms.pairs", "pair_fetch_ms.pairs",
           "vo_dispatch_ms.vo", "vo_wait_ms.vo", "vo_decode_ms.vo", "idle_in_wait.vo",
           "step_launch_ms.train", "batch_wait_ms.train", "capture_s"]
US = 1000  # ns


class Spans:
    """A synthetic ring: ``add`` takes µs on the perf clock."""

    def __init__(self):
        self.spans, self.next_id = [], 1

    def add(self, name, a, b, parent=None, profiled=False, thread=1, **attrs):
        s = Span(name, int(a * US), int(b * US), self.next_id, parent and parent.id, thread,
                 profiled, attrs)
        self.next_id += 1
        self.spans.append(s)
        return s


def _read(name, spans, monkeypatch, trace=None):
    monkeypatch.setattr(span_read, "spans", lambda: sorted(spans.spans,
                                                           key=lambda s: s.start_ns))
    return harness.reader(name).read(SimpleNamespace(trace=trace, layer={}, peaks={}))


def _pair_call(r, t0, copy_in, launch, fetch, capture=False, profiled=False):
    call = r.add("infer.call", t0, t0 + copy_in + launch + fetch + (500 if capture else 0),
                 profiled=profiled, call=0)
    r.add("infer.frames", t0, t0 + copy_in / 2, call, profiled)
    r.add("graph.copy_in", t0 + copy_in / 2, t0 + copy_in, call, profiled, program="p")
    t = t0 + copy_in
    if capture:
        r.add("graph.capture", t, t + 500, call, profiled, program="p")
        t += 500
    r.add("graph.replay", t, t + launch, call, profiled, program="p")
    r.add("infer.fetch", t + launch, t + launch + fetch, call, profiled, bytes=8)


def test_pair_readers_take_the_window_calls(monkeypatch):
    r = Spans()
    _pair_call(r, 0, 9000, 9000, 9000, capture=True)  # set-up: captures, left out
    for i, (c, l, f) in enumerate([(600, 1500, 300), (700, 1700, 350), (650, 1600, 320)]):
        _pair_call(r, 20000 + 5000 * i, c, l, f)
    for i in range(5):  # traced after the window: left out
        _pair_call(r, 50000 + 5000 * i, 4000, 4000, 4000, profiled=True)
    assert _read("pair_copy_in_ms.pairs", r, monkeypatch) == pytest.approx(0.65)
    assert _read("pair_launch_ms.pairs", r, monkeypatch) == pytest.approx(1.6)
    assert _read("pair_fetch_ms.pairs", r, monkeypatch) == pytest.approx(0.32)


def _chunk(r, t0, slot_wait, drain, busy, k, thread=1, profiled=False):
    chunk = r.add("vo.chunk", t0, t0 + slot_wait + drain + busy, thread=thread,
                  profiled=profiled, chunk=k)
    r.add("vo.drain", t0, t0 + drain, chunk, profiled, thread, chunk=k - 8)
    r.add("vo.slot_wait", t0 + drain, t0 + drain + slot_wait, chunk, profiled, thread, chunk=k)
    r.add("vo.stage", t0 + drain + slot_wait, t0 + drain + slot_wait + busy, chunk, profiled,
          thread, chunk=k)
    return chunk


def test_vo_readers_split_a_chunk_into_dispatch_and_waits(monkeypatch):
    r = Spans()
    for k, (w, d, b) in enumerate([(100, 2000, 1000), (300, 4000, 1200), (200, 3000, 1100)]):
        _chunk(r, 20000 * k, w, d, b, k)
        t = 20000 * k + 5000
        r.add("vo.decode", t, t + 2500 + 100 * k, thread=2, chunk=k)
    _chunk(r, 90000, 9000, 9000, 9000, 9, profiled=True)
    r.add("vo.decode", 90000, 99000, thread=2, profiled=True, chunk=9)
    assert _read("vo_dispatch_ms.vo", r, monkeypatch) == pytest.approx(1.1)
    assert _read("vo_wait_ms.vo", r, monkeypatch) == pytest.approx(3.2)
    assert _read("vo_decode_ms.vo", r, monkeypatch) == pytest.approx(2.6)


def _trace(offset_us):
    """Kernels at 100-200, 300-400, 500-600 µs (idle 200-300 and 400-500) on
    the trace's clock, a graph launch before each."""
    events = []
    for a in (100, 300, 500):
        events.append({"ph": "X", "cat": "kernel", "name": "k", "ts": a, "dur": 100})
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
                       "ts": a - 10, "dur": 4})
    return Trace(events, 1e-3), offset_us


def test_idle_in_wait_places_the_waits_on_the_trace(monkeypatch):
    trace, offset = _trace(-1000.0)  # a span at perf µs t lies at t - 1000 on the trace
    r = Spans()
    for a in (100, 300, 500):
        r.add("graph.replay", a - 10 + 1000 - 1, a - 10 + 1000 + 5, profiled=True, program="c")
    r.add("vo.drain", 1200, 1250, profiled=True)  # 50 µs of the first gap
    r.add("vo.slot_wait", 1420, 1520, profiled=True)  # 80 µs of the second
    r.add("vo.drain", 1200, 1300)  # not traced: left out
    clock = span_read.trace_clock(trace, r.spans)
    assert clock[0] == pytest.approx(offset) and clock[2] == pytest.approx(0.0)
    assert _read("idle_in_wait.vo", r, monkeypatch, trace) == pytest.approx(65.0)
    r.add("graph.replay", 2000, 2005, profiled=True, program="c")  # a replay without a launch
    assert span_read.trace_clock(trace, r.spans) is None
    assert _read("idle_in_wait.vo", r, monkeypatch, trace) is None


def test_training_readers_take_the_step_replay_and_the_batch(monkeypatch):
    r = Spans()
    t = 0
    for i, (batch, launch) in enumerate([(90000, 90000), (300, 1000), (500, 2800), (400, 1100)]):
        b = r.add("loop.batch", t, t + batch, step=i)
        r.add("graph.replay", t, t + batch / 2, b, program="batch")
        if i == 0:
            r.add("graph.capture", t, t + batch / 2, b, program="batch")
        s = r.add("loop.step", t + batch, t + batch + launch + 50, step=i)
        if i == 0:
            r.add("graph.capture", t + batch, t + batch + launch / 2, s, program="train_step")
        r.add("graph.replay", t + batch + 50, t + batch + 50 + launch, s, program="train_step")
        t += 100000
    s = r.add("loop.step", t, t + 9000, step=4)  # the profiler opened inside this step
    r.add("graph.replay", t + 10, t + 8000, s, profiled=True, program="train_step")
    assert _read("step_launch_ms.train", r, monkeypatch) == pytest.approx(1.1)
    assert _read("batch_wait_ms.train", r, monkeypatch) == pytest.approx(0.4)
    assert _read("capture_s", r, monkeypatch) == pytest.approx((45000 + 45000) / 1e6)


def test_without_the_recorder_every_reader_gives_none(monkeypatch):
    import colvo_torch.runtime

    monkeypatch.delattr(colvo_torch.runtime, "spans")  # an older program: the import fails
    monkeypatch.setitem(sys.modules, "colvo_torch.runtime.spans", None)
    assert span_read.spans() is None
    trace, _ = _trace(0.0)
    for name in READERS:
        assert harness.reader(name).read(SimpleNamespace(trace=trace, layer={}, peaks={})) \
            is None, name


def test_an_empty_ring_gives_none(monkeypatch):
    trace, _ = _trace(0.0)
    for name in READERS:
        assert _read(name, Spans(), monkeypatch, trace) is None, name


def test_every_reader_is_declared():
    declared = {m["name"] for m in harness.benchmark()["per_layer"]}
    assert set(READERS) <= declared
