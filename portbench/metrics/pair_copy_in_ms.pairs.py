"""Median ms a pair call spends from its start (``infer.call``) to its
program's replay: the frames made tensors and copied from pageable memory
into the static inputs (the program's spans, outside the profiler)."""

from portbench import span_read


def read(run):
    calls = span_read.requests("infer.call")
    return span_read.median((by["graph.replay"][0].start_ns - call.start_ns) / 1e6
                            for call, by in calls or () if by["graph.replay"])
