"""Captured programs: the port's counterpart of the reference's ``jax.jit``.

``Graphed(fn)`` is called as ``fn`` is. Its arguments are tensors, tuples,
lists and dicts of them, and other (static) values. Each call is keyed by
its input signature, as jit's cache is: the shapes, dtypes and devices of
the tensors, the structure around them and the values of the static
arguments.

On a CUDA device the first call of a signature copies the tensors into
static input buffers, runs ``fn`` on them ``WARMUP`` times on a side
stream (kernel builds, cuDNN's choices, lazily made state such as Adam's
moments come into being there), puts back the state that ``fn`` mutates
(``state``, ``generators``), and captures one call into a
``torch.cuda.CUDAGraph``. That call and every later one of the signature
copy their tensors into the static inputs and replay the graph, so the
host dispatches once a call. A capture that fails raises: nothing falls
back to eager calls on the card.

The result is the graph's static outputs (in a fresh container): the next
call of the same signature overwrites them, so a caller that keeps one
past that copies it. On the CPU the same buffer semantics hold: the
tensors are copied into the static inputs, ``fn`` runs eagerly on them
and its results are copied into the static outputs, so the CPU tests catch
a caller that keeps an output too long.

The port's programs, each a ``jax.jit`` of the reference:
``InferenceRunner``'s three functions, ``StreamingVO``'s init and chunk
steps, the loop's step (``make_train_step``), ``make_scan_train``'s chunk,
``vo.refine``'s refinement, the device store's batch
(``data/device_store.py``, the reference's ``_assemble`` and
``augment_fn``) and the eval hook's forward (``pipelines.py``, its
``_eval_fwd``). Only the step under a mesh of more than one rank and under
``train.debug_nans`` runs eagerly on the card (``runtime/loop.py::make_step_fn``).

The kernels' launch counters stay exact: the warm-up's launches count as
they happen, the capture (which launches nothing) is taken back out, and
each replay adds the launches it captured (``kernels.add_launch_counts``).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import torch

from colvo_torch.kernels import add_launch_counts, launch_counts, reset_launch_counts

# Eager calls of a body on a side stream before its capture: one brings
# its lazily made state into being, and the capture reads nothing else.
WARMUP = 1

# The warm-up's side stream, one a device for every capture: the libraries
# keep state a stream that is never given back, so with a new stream each
# capture a training run of three attempts (restarts) left 0.1875 GiB more
# allocated on the H100 every time it ran.
_SIDE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return _SIDE_STREAMS[index]


def _flatten(obj: Any, leaves: List[torch.Tensor]) -> tuple:
    """The tensors of ``obj``, in order, into ``leaves``; returns a hashable
    skeleton of ``obj`` with each tensor's signature in its place."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("tensor", tuple(obj.shape), obj.dtype, str(obj.device))
    if isinstance(obj, (tuple, list)):
        return (type(obj), tuple(_flatten(o, leaves) for o in obj))
    if isinstance(obj, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in obj.items()))
    return ("static", obj)


def _unflatten(skeleton: tuple, tensors: Iterator[torch.Tensor]) -> Any:
    kind, *rest = skeleton
    if kind == "tensor":
        return next(tensors)
    if kind == "static":
        return rest[0]
    if kind is dict:
        return {k: _unflatten(s, tensors) for k, s in rest[0]}
    return kind(_unflatten(s, tensors) for s in rest[0])


@dataclass
class Program:
    """One signature's static buffers and graph (None on the CPU)."""

    inputs: List[torch.Tensor]
    in_skeleton: tuple
    outputs: List[torch.Tensor] = field(default_factory=list)
    out_skeleton: tuple = ()
    graph: Optional[torch.cuda.CUDAGraph] = None
    launches: Dict[str, int] = field(default_factory=dict)

    def result(self) -> Any:
        return _unflatten(self.out_skeleton, iter(self.outputs))


class Graphed:
    """``fn`` captured once a signature and replayed (see the module's
    docstring).

    Args:
        fn: the body; a function of tensors that launches work on the
            current stream and reads no device value on the host.
        device: where the static inputs live; by default each input
            tensor's own device. Inputs may then come from the host and are
            copied straight into the static buffers.
        state: returns the tensors that ``fn`` updates in place (weights,
            Adam's moments, counters). Their values are put back after the
            warm-up; one the warm-up brought into being is zeroed.
        generators: generators ``fn`` draws from: their states are put
            back after the warm-up and they are registered with the graph,
            so that each replay draws anew.

    Attributes:
        programs: signature → :class:`Program`.
    """

    def __init__(self, fn: Callable, device: Optional[torch.device] = None,
                 state: Optional[Callable[[], Iterable[torch.Tensor]]] = None,
                 generators: Sequence[torch.Generator] = ()):
        self.fn, self.device, self.state = fn, device, state
        self.generators = tuple(generators)
        self.programs: Dict[tuple, Program] = {}

    def __call__(self, *args, **kwargs) -> Any:
        tensors: List[torch.Tensor] = []
        key = _flatten((args, kwargs), tensors)
        device = self.device or (tensors[0].device if tensors else torch.device("cpu"))
        prog = self.programs.get(key)
        if prog is None:
            inputs = [torch.empty(t.shape, dtype=t.dtype, device=device) for t in tensors]
            prog = Program(inputs, key)
        for s, t in zip(prog.inputs, tensors):
            s.copy_(t)
        if device.type != "cuda":
            self._run_eager(prog)
        else:
            if prog.graph is None:
                self._capture(prog, device)
            prog.graph.replay()
            add_launch_counts(prog.launches)
        self.programs[key] = prog
        return prog.result()

    def _call_fn(self, prog: Program) -> Any:
        args, kwargs = _unflatten(prog.in_skeleton, iter(prog.inputs))
        return self.fn(*args, **kwargs)

    def _run_eager(self, prog: Program) -> None:
        outputs: List[torch.Tensor] = []
        skeleton = _flatten(self._call_fn(prog), outputs)
        if not prog.outputs:
            prog.outputs, prog.out_skeleton = outputs, skeleton
            return
        if skeleton != prog.out_skeleton:
            raise ValueError("the body returned another structure than on its first call")
        for s, o in zip(prog.outputs, outputs):
            s.copy_(o)

    def _capture(self, prog: Program, device: torch.device) -> None:
        """Warm up on a side stream, put the state back, capture one call."""
        saved = {id(t): (t, t.clone()) for t in (self.state() if self.state else ())}
        rngs = [g.get_state() for g in self.generators]
        current = torch.cuda.current_stream(device)
        side = _side_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self._call_fn(prog)
        current.wait_stream(side)
        with torch.no_grad():
            for t in (self.state() if self.state else ()):
                if id(t) in saved:
                    t.copy_(saved[id(t)][1])
                else:  # made by the warm-up: it starts at zero
                    t.zero_()
        for g, rng in zip(self.generators, rngs):
            g.set_state(rng)
        del saved

        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        before = launch_counts()
        try:
            # thread_local: other threads (the batch producer, the metrics
            # and fetch threads) may go on using the card meanwhile
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                out = self._call_fn(prog)
        finally:
            captured = dict(Counter(launch_counts()) - Counter(before))
            reset_launch_counts()
            add_launch_counts(before)
        prog.out_skeleton = _flatten(out, prog.outputs)
        prog.graph, prog.launches = graph, captured
