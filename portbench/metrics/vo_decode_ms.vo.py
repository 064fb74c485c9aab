"""Median ms a fetch thread takes to decode a chunk's wire (``vo.decode``),
outside the profiler."""

from portbench import span_read


def read(run):
    decodes = span_read.requests("vo.decode")
    return span_read.median(d.ms for d, _ in decodes or ())
