"""Nothing the benchmark runs loads JAX or the JAX package ``colvo``, whose
name the port's begins with: top-level module names are compared whole.
The reference loads nothing of the program either."""

import json
import subprocess
import sys

from portbench import harness

PROBE = """
import json, sys
sys.modules.setdefault("torch.utils.tensorboard", None)
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)],
                         capture_output=True, text=True, cwd=harness.ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_drivers_load_no_jax():
    names = _top_level("import portbench.run, portbench.harness, portbench.trace\n"
                       "import portbench.kinds.train, portbench.kinds.vo, portbench.kinds.pairs\n"
                       "import colvo_torch.runtime.loop, colvo_torch.vo.driver")
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)
    assert "colvo_torch" in names  # the name check does not take the port for colvo


def test_reference_loads_nothing_of_the_program():
    names = _top_level("import portbench.reference.model, portbench.reference.loss\n"
                       "import portbench.reference.train, portbench.reference.data\n"
                       "import portbench.reference.quant")
    assert not names & (set(harness.FORBIDDEN) | {"colvo_torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "colvo_torch_like", object())
    assert "colvo" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "colvo.kernels", object())
    assert "colvo" in harness.forbidden_modules()
