"""Training traffic on a DPT depth net (``model.depth_net``): ``kinds.train``'s
run, window and check, with the weights drawn and the forward computed by
``reference/dpt.py`` where ``kinds.train`` takes ``reference/model.py``'s.

Parameters: as ``kinds.train``'s. The wrapper around the loop's step
function also reads, around each step call, the attention calls that
step launched (the ``attn/fwd`` launch counter, which a replay of the
captured step adds), and ``layer["attn_calls"]`` gives the last steady
step's for the attention roofline. A program without the counter gives
0 there, and the reader nothing.
"""

from __future__ import annotations

from unittest import mock

from portbench import weights
from portbench.harness import Ctx, Outcome
from portbench.kinds import train
from portbench.reference import dpt
from portbench.reference import train as ref_train

ATTN = "attn/fwd"


def _attn_launches() -> int:
    from colvo_torch.kernels import launch_counts

    return launch_counts().get(ATTN, 0)


def run(ctx: Ctx) -> Outcome:
    made = []

    class Stepper(train.Stepper):
        def __init__(self, *args):
            super().__init__(*args)
            self.attn_calls = None
            made.append(self)

        def __call__(self, state, batch):
            before = _attn_launches()
            metrics = super().__call__(state, batch)
            self.attn_calls = _attn_launches() - before
            return metrics

    with mock.patch.object(train, "Stepper", Stepper), \
            mock.patch.object(weights, "make", dpt.weights), \
            mock.patch.object(ref_train, "snippet_forward", dpt.snippet_forward):
        out = train.run(ctx)
    out.layer["attn_calls"] = made[-1].attn_calls if made else None
    return out
