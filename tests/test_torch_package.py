"""The port stands alone: nothing under ``src/repro_torch`` (nor
``chip_smoke.py``) imports JAX or the reference package."""
from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro(?!_torch)\b)", re.M)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path.relative_to(ROOT)}: {hits}"


def test_every_module_imports_without_jax():
    modules = sorted(
        "repro_torch" + ("." + ".".join(p.relative_to(PORT).with_suffix("").parts)
                         if p.name != "__init__.py" or p.parent != PORT else "")
        for p in PORT.rglob("*.py")
    )
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('PASS', len(sys.argv))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120, cwd=ROOT)
    assert proc.returncode == 0 and "PASS" in proc.stdout, proc.stderr[-3000:]
    assert len(modules) >= 20
