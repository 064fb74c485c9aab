"""What every cell shares: finding its files by name, its configuration,
the checks against its limits, the result line.

A cell's files: the configuration named by its ``config``
(``BENCHMARK.json``'s ``configs[].file``: ``overrides`` of ``ColvoConfig``),
``traffic/<traffic>.json`` (whose ``kind`` names the driver in
``kinds/``, and whose other keys are the driver's parameters),
``limits/<cell>.json`` (the limit of each compared number, with the
readings it was set from) and ``metrics/<name>.py`` for each per-layer
metric (a ``read(run)`` that returns a number or None).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "colvo")


@dataclass
class Ctx:
    """One run of one cell."""

    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    overrides: Dict[str, object] = field(default_factory=dict)  # smaller sizes (tests)
    readings: Tuple[str, ...] = ()  # extra readings: "control", "half" (calibration)

    def colvo_config(self):
        from colvo_torch.config import ColvoConfig

        cfg = ColvoConfig()
        items = {**self.config.get("overrides", {}), **self.traffic.get("overrides", {}),
                 **self.overrides}
        cfg.apply_overrides([f"{k}={json.dumps(v)}" for k, v in items.items()
                             if "." in k and k.split(".")[0] in cfg.to_dict()])
        cfg.train.seed = self.seed
        return cfg

    def param(self, key: str):
        """A traffic parameter, as the test sizes may override it."""
        return self.overrides.get(key, self.traffic[key])


@dataclass
class Outcome:
    """What a driver hands back."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    numbers: Dict[str, float]
    memory_peak_bytes: int
    readings: Dict[str, Dict[str, float]] = field(default_factory=dict)
    trace: Optional[object] = None
    layer: Dict[str, object] = field(default_factory=dict)


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(name: str, bench: Optional[dict] = None) -> tuple:
    """(workload entry, configuration file, traffic file, limits file,
    end-to-end metric entries, per-layer metric entries) of cell ``name``."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())

    def mine(m):
        return name in m.get("workloads", [name])

    return (w, config, traffic, limits, [m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def driver(kind: str):
    return importlib.import_module(f"portbench.kinds.{kind}")


def reader(metric: str):
    """The module ``metrics/<metric>.py`` (names may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def judge(numbers: Dict[str, float], limits: dict) -> Tuple[bool, List[tuple]]:
    """(correct, [(name, value, limit)]): every number at most its limit
    and finite."""
    rows, ok = [], True
    for name, entry in limits["limits"].items():
        value = numbers.get(name, float("nan"))
        rows.append((name, value, entry["limit"]))
        ok = ok and math.isfinite(value) and value <= entry["limit"]
    return ok, rows


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    import sys

    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
