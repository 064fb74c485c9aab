"""Run one cell of ``BENCHMARK.json`` on this machine's card.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit,
which also close standard error. Exits non-zero, printing no result, where
there is no CUDA card or fewer than the cell asks for, where the program
is not beside the benchmark, and where a module of JAX or of the JAX
package ``colvo`` was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def environment() -> None:
    """Caches at fixed paths inside the checkout; no TensorBoard (its import
    loads TensorFlow) and no Flax."""
    cache = ROOT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    sys.modules.setdefault("torch.utils.tensorboard", None)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def execute(ctx, e2e_metrics, layer_metrics, power: str = "") -> dict:
    """Run the cell's driver; the result's dict."""
    import torch

    from portbench import harness

    out = harness.driver(ctx.traffic["kind"]).run(ctx)
    correct, rows = harness.judge(out.numbers, ctx.limits)
    on_card = ctx.device.type == "cuda"
    if ctx.trace:
        run = SimpleNamespace(trace=out.trace, layer=out.layer, peaks=PEAKS)
        metrics = {}
        for m in layer_metrics:
            value = harness.reader(m["name"]).read(run) if on_card else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"]], "unit": m["unit"]}
                   for m in e2e_metrics}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(ctx.device) if on_card else "cpu",
              "count": int(ctx.workload["chips"]), "memory_peak_bytes": int(out.memory_peak_bytes),
              "power_limit": power}
    result = {"correct": bool(correct and out.failed == 0), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": device}
    if ctx.trace and out.trace is not None:
        device["busy_s"], device["window_s"] = out.trace.busy_s, out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
    if out.readings:
        result["readings"] = out.readings
    marks = out.layer.get("setup")
    if marks:
        parts = [("imports and card", marks[0][1] - ctx.t_start)]
        parts += [(name, t - prev) for (_, prev), (name, t) in zip(marks, marks[1:])]
        print("setup parts (s): " + "; ".join(f"{n} {v:.3f}" for n, v in parts),
              file=sys.stderr)
    other = {k: v for k, v in out.numbers.items() if k not in ctx.limits["limits"]}
    if other:
        print("numbers not compared: " + json.dumps(other), file=sys.stderr)
    if on_card:
        print(f"peak device memory: {out.memory_peak_bytes / 2**30:.3f} GiB", file=sys.stderr)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if importlib.util.find_spec("colvo_torch") is None:
        print("colvo_torch is not beside the benchmark: nothing to measure", file=sys.stderr)
        return 2
    environment()
    import torch

    from portbench import harness

    w, config, traffic, limits, e2e_metrics, layer_metrics = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"{args.workload} needs {w['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    power = power_limit()
    print(f"card: {power}", file=sys.stderr)
    ctx = harness.Ctx(w, config, traffic, limits, args.seed & (2**63 - 1), args.seconds,
                      bool(args.trace), torch.device("cuda", 0), T_START)
    result = execute(ctx, e2e_metrics, layer_metrics, power)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
