"""Median ms a VO chunk keeps the calling thread busy (``vo.chunk`` less its
``vo.slot_wait`` and ``vo.drain``: staging, the copies queued, the
replay), outside the profiler."""

from portbench import span_read


def read(run):
    chunks = span_read.requests("vo.chunk")
    return span_read.median(chunk.ms - span_read.ms(by["vo.slot_wait"] + by["vo.drain"])
                            for chunk, by in chunks or ())
