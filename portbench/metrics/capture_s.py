"""Seconds of the run spent warming up and capturing the programs
(``graph.capture`` spans, summed)."""

from portbench import span_read


def read(run):
    every = span_read.spans()
    captures = [s for s in every or () if s.name == "graph.capture"]
    return sum(s.ms for s in captures) / 1e3 if captures else None
