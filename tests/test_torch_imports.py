"""Import hygiene: the port never imports JAX or the JAX package.

Every module of `repro_torch` is imported in a fresh interpreter whose
import system refuses `jax*` and `repro`/`repro.*`; `chip_smoke.py` is
parsed and must import neither, and so is the tie-rule helper it shares
with the tests.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top == "repro" or top.startswith("jax"):
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
mods = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch."))
for m in mods:
    importlib.import_module(m)
bad = [k for k in sys.modules
       if k == "repro" or k.startswith("repro.") or k.startswith("jax")]
assert not bad, bad
print(len(mods), " ".join(mods))
"""

# the modules of the serving slice (ROADMAP.md, Open items 1, item 1)
EXPECTED = {
    "repro_torch.kernels.common", "repro_torch.kernels.incidents",
    "repro_torch.kernels._build", "repro_torch.kernels.registry",
    "repro_torch.kernels.spikemm.ops", "repro_torch.kernels.spikemm.ref",
    "repro_torch.kernels.linrec.ops", "repro_torch.kernels.linrec.ref",
    "repro_torch.kernels.lif.ops", "repro_torch.kernels.lif.ref",
    "repro_torch.core.surrogate", "repro_torch.core.neuron",
    "repro_torch.core.events", "repro_torch.core.plan",
    "repro_torch.core.snn_layers", "repro_torch.data.spikes",
    "repro_torch.serve.metrics", "repro_torch.serve.scheduler",
    "repro_torch.serve.sessions", "repro_torch.serve.engine",
    "repro_torch.weights",
}


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    imported = set(p.stdout.split()[1:])
    assert EXPECTED <= imported, EXPECTED - imported


def _imported_names(path: Path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def test_chip_smoke_imports_no_jax_and_no_reference():
    names = _imported_names(ROOT / "chip_smoke.py")
    assert "repro_torch.serve" in names or any(
        n.startswith("repro_torch") for n in names)
    bad = [n for n in names if n.split(".")[0] == "repro"
           or n.split(".")[0].startswith("jax")]
    assert not bad, bad


def test_tie_rule_helper_imports_no_jax_and_no_reference():
    names = _imported_names(ROOT / "tests" / "_torch_parity.py")
    bad = [n for n in names if n.split(".")[0] in ("repro", "repro_torch")
           or n.split(".")[0].startswith("jax")]
    assert not bad, bad
