"""Median ms a pair call spends fetching its outputs to the host
(``infer.fetch``: the wait for the card and the copies), outside the
profiler."""

from portbench import span_read


def read(run):
    calls = span_read.requests("infer.call")
    return span_read.median(span_read.ms(by["infer.fetch"])
                            for _, by in calls or () if by["infer.fetch"])
