"""Toy sizes for the CPU tests of the benchmark (``test_portbench_*.py``):
every cell's driver runs end to end on the CPU at 64×96 with a batch of
2, without the look for a card, and its numbers are judged against the
cell's limits."""

from __future__ import annotations

import sys
import time

import torch

from portbench import harness

TOY = {"data.height": 64, "data.width": 96, "data.batch_size": 2, "sequences": 2, "frames": 8,
       "warm_steps": 1, "calibrate_steps": 2, "trace_steps": 1, "pool_frames": 12,
       "warm_frames": 9, "trace_frames": 9, "check_frames": 3, "warm_calls": 1,
       "trace_calls": 2, "check_calls": 4,
       "vo": {"chunk_size": 4, "depth_dtype": "uint8", "symmetric_pose": True,
              "keyframe_every": 2}}


def toy_run(cell: str, seconds: float = 1.0, trace: bool = False, readings=(),
            seed: int = 2**31 + 11) -> dict:
    """The result line of ``cell`` at the toy sizes on the CPU."""
    sys.modules.setdefault("torch.utils.tensorboard", None)
    torch.set_num_threads(2)  # the tests run in several processes
    from portbench.run import execute

    w, config, traffic, limits, e2e, layer = harness.load_cell(cell)
    ctx = harness.Ctx(w, config, traffic, limits, seed, seconds, trace, torch.device("cpu"),
                      time.perf_counter(), overrides=dict(TOY), readings=tuple(readings))
    return execute(ctx, e2e, layer)
