"""colvo_torch stands alone: importing every module of the package loads
no JAX-family module and nothing of the JAX package, and no source file
of the package, nor chip_smoke.py, imports one, nor a plotting or image
library (the card's host has neither). cv2 (for JPEG, BMP and video only)
and PIL are never loaded by an import."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "colvo_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "colvo")
ABSENT_ON_THE_CARD = ("matplotlib", "imageio", "PIL")
NOT_LOADED_BY_AN_IMPORT = ABSENT_ON_THE_CARD + ("cv2",)

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import colvo_torch
names = [m.name for m in pkgutil.walk_packages(colvo_torch.__path__, "colvo_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
"""


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_every_module_loads_no_jax_or_colvo():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "colvo_torch.kernels.sampler" in result["imported"]
    assert "colvo_torch.kernels.fused_loss" in result["imported"]
    assert "colvo_torch.runtime.train_step" in result["imported"]
    for name in ("colvo_torch.vo.stream", "colvo_torch.native", "colvo_torch.evaluation.pose"):
        assert name in result["imported"]
    for name in ("runtime.loop", "runtime.checkpoint", "runtime.metrics", "data.prefetch",
                 "data.device_store", "pipelines", "cli", "evaluation.viz", "data.png",
                 "data.sources", "data.benchmark", "evaluation.raster", "runtime.torch_import",
                 "runtime.optim", "data.grain_loader", "runtime.mesh", "vo.refine"):
        assert f"colvo_torch.{name}" in result["imported"]
    assert [m for m in result["loaded"] if _forbidden(m)] == []
    assert [m for m in result["loaded"] if m.split(".")[0] in NOT_LOADED_BY_AN_IMPORT] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_forbidden(path):
    bad = [m for m in _imports(path)
           if _forbidden(m) or m.split(".")[0] in ABSENT_ON_THE_CARD]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_the_grain_loader_loads_neither_grain_nor_jax():
    """The port's checkpointable loader keeps grain's contract without
    grain, whose import loads JAX."""
    code = ("import json, sys; import colvo_torch.data.grain_loader; "
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=300)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if m.split(".")[0] in ("grain", "jax", "jaxlib")] == []


SCRIPTS = ("demo_synthetic", "fullcolon", "ablate", "gauge_validate", "gauge2_requeue",
           "basin_levers", "figures", "scale_decoupling", "gauge_probe", "longvideo",
           "drift_audit", "expjit_analysis", "expjit_mechanism")


def test_the_scripts_load_neither_jax_nor_bench():
    """The port's workflows (``colvo_torch/scripts``) keep their own copy of
    what they need from the repository's ``scripts/`` and ``bench.py``:
    importing them loads neither, nor JAX, nor a plotting or image library
    (the long-video figure is drawn by ``raster.Axes2D``), and no source of
    the port or ``chip_smoke.py`` imports either."""
    names = tuple(f"colvo_torch.scripts.{n}" for n in SCRIPTS)
    code = (f"import json, sys; import {', '.join(names)}; "
            "from colvo_torch.evaluation.raster import Axes2D; "
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=300)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(names) <= set(loaded)
    assert [m for m in loaded if m.split(".")[0] in FORBIDDEN + ("bench", "scripts")] == []
    assert [m for m in loaded if m.split(".")[0] in NOT_LOADED_BY_AN_IMPORT] == []
    for path in sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        bad = [m for m in _imports(path) if m.split(".")[0] in ("bench", "scripts")]
        assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"
