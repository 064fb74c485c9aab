"""Median ms a pair call spends in its program's replay (``graph.replay``,
the CUDA graph's launch on the host), outside the profiler."""

from portbench import span_read


def read(run):
    calls = span_read.requests("infer.call")
    return span_read.median(span_read.ms(by["graph.replay"])
                            for _, by in calls or () if by["graph.replay"])
