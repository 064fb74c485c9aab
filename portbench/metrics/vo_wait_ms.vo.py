"""Median ms a VO chunk's calling thread waits (``vo.slot_wait`` for the
pinned slot, ``vo.drain`` for the oldest chunk's results), outside the
profiler."""

from portbench import span_read


def read(run):
    chunks = span_read.requests("vo.chunk")
    return span_read.median(span_read.ms(by["vo.slot_wait"] + by["vo.drain"])
                            for _, by in chunks or ())
