"""Share of the traced run_vo call's device-idle time (the gaps between its
device intervals) in which the calling thread was inside ``vo.slot_wait``
or ``vo.drain``. The traced call's spans are put on the trace's clock by
matching each profiled ``graph.replay`` to the ``cudaGraphLaunch`` inside
it (``span_read.trace_clock``)."""

from portbench import span_read


def read(run):
    every = span_read.spans()
    if run.trace is None or not every:
        return None
    clock = span_read.trace_clock(run.trace, every)
    gaps = span_read.idle_gaps(run.trace)
    total = float((gaps[:, 1] - gaps[:, 0]).sum())
    if clock is None or total <= 0:
        return None
    offset = clock[0]
    waits = [s for s in every if s.profiled and s.name in ("vo.slot_wait", "vo.drain")]
    inside = sum(span_read.overlap_us(gaps, s.start_ns / 1e3 + offset, s.end_ns / 1e3 + offset)
                 for s in waits)
    return 100.0 * inside / total
