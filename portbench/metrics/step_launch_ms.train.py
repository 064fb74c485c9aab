"""Median ms a training step spends in the step program's replay
(``graph.replay`` of ``train_step`` inside ``loop.step``: the CUDA graph's
launch on the host), outside the profiler."""

from portbench import span_read


def read(run):
    steps = span_read.requests("loop.step")
    return span_read.median(
        r.ms for _, by in steps or () for r in by["graph.replay"]
        if r.attrs.get("program") == "train_step" and not r.profiled)
