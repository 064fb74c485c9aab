"""Readings that a cell's output limits are set from, many seeds in one process.

    python -m portbench.calibrate --workload <cell> --seeds 1 2 3 ... \
        [--control N] [--seconds S]

For each seed: the program's compared numbers (a short window of
``--seconds``; training cells need none and take 0: their three checked
steps), and for the first ``N`` seeds the readings of the float8 control
put in the program's place and, on training cells, of the fault that
leaves out half of every batch. One JSON line a seed. Runs on the card
only, as ``run`` does.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    from portbench import run

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    run.environment()
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    w, config, traffic, limits, _, _ = harness.load_cell(args.workload)
    for i, seed in enumerate(args.seeds):
        extra = ("control", "half") if i < args.control else ()
        if traffic["kind"] != "train":
            extra = tuple(r for r in extra if r != "half")
        t0 = time.perf_counter()
        ctx = harness.Ctx(w, config, traffic, limits, seed, args.seconds, False,
                          torch.device("cuda", 0), t0, readings=extra)
        out = harness.driver(traffic["kind"]).run(ctx)
        print(json.dumps({"workload": args.workload, "seed": seed, "numbers": out.numbers,
                          "readings": out.readings, "e2e": out.e2e,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del out
        harness.free(ctx.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
