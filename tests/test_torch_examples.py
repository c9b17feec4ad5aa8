"""The port's BCI and quickstart examples run end to end on the CPU
(`--device cpu`), each in a fresh interpreter, and print what their JAX
twins print: the BCI decoder's per-day accuracies before and after the
on-chip fine-tune and the simulated power; the quickstart's topology,
plan, run, mapping and simulated power."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                        "--device", "cpu", *args], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


def test_bci_onchip_torch_runs_on_the_cpu():
    out = _run("bci_onchip_torch.py", "--steps", "3")
    lines = out.splitlines()
    days = [ln.split() for ln in lines
            if ln.strip()[:1].isdigit() and len(ln.split()) == 3]
    assert [d[0] for d in days] == ["1", "2", "3"]
    assert all(0.0 <= float(v) <= 1.0 for d in days for v in d[1:])
    assert "simulated TaiBai" in out and "W," in out


def test_quickstart_torch_runs_on_the_cpu():
    out = _run("quickstart_torch.py")
    for what in ("topology:", "plan: fused_rec[hidden]:alif", "ran 100",
                 "mapped to", "simulated TaiBai"):
        assert what in out, (what, out)
