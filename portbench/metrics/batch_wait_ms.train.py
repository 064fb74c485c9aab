"""Median ms the loop waits for its next batch (``loop.batch``: on the device
loader the batch program's copies and replay), outside the profiler."""

from portbench import span_read


def read(run):
    batches = span_read.requests("loop.batch")
    return span_read.median(b.ms for b, _ in batches or ())
