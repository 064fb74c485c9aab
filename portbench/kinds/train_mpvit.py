"""Training traffic on an MPViT depth net (``model.depth_net``):
``kinds.train``'s run, window and check, with the weights drawn and the
forward computed by ``reference/mpvit.py`` where ``kinds.train`` takes
``reference/model.py``'s.

Parameters: as ``kinds.train``'s. The weights include BatchNorm's running
statistics, which the reference's steps leave where they are (no
gradient reaches them, so the compared leaves leave them out); the
wrapper around the loop's step function adds the program's buffers to
the weights it keeps after the third step. It also reads, around each
step call, the FA calls that step launched (the ``FA/fwd`` launch
counter, which a replay of the captured step adds), and
``layer["fa_calls"]`` gives the last steady step's for the roofline. A
program without the counter gives 0 there, and the reader nothing.
"""

from __future__ import annotations

from unittest import mock

from portbench import weights
from portbench.harness import Ctx, Outcome
from portbench.kinds import train
from portbench.reference import mpvit
from portbench.reference import train as ref_train

FA = "FA/fwd"


def _fa_launches() -> int:
    from colvo_torch.kernels import launch_counts

    return launch_counts().get(FA, 0)


def run(ctx: Ctx) -> Outcome:
    made = []

    class Stepper(train.Stepper):
        def __init__(self, *args):
            super().__init__(*args)
            self.fa_calls = None
            made.append(self)

        def __call__(self, state, batch):
            before = _fa_launches()
            metrics = super().__call__(state, batch)
            self.fa_calls = _fa_launches() - before
            if self.calls == train.CHECKED:
                self.theta.update({n: b.detach().clone()
                                   for n, b in state.model.named_buffers()})
            return metrics

    with mock.patch.object(train, "Stepper", Stepper), \
            mock.patch.object(weights, "make", mpvit.weights), \
            mock.patch.object(ref_train, "snippet_forward", mpvit.snippet_forward):
        out = train.run(ctx)
    out.layer["fa_calls"] = made[-1].fa_calls if made else None
    return out
