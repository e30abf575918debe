"""The port never loads JAX or the JAX package.

tests/conftest.py imports jax into every test process, so the import check
runs in a fresh interpreter."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import aligngraph2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "aligngraph2_tpu" or m.startswith("aligngraph2_tpu."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 15, names
"""


def test_port_modules_load_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _sources():
    for base, _, files in os.walk(os.path.join(ROOT, "aligngraph2_tpu_torch")):
        for f in files:
            if f.endswith((".py", ".cu", ".cpp")):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("pattern", [r"\bimport jax\b", r"\bfrom jax\b",
                                     r"aligngraph2_tpu\."])
def test_port_sources_name_no_jax(pattern):
    hits = []
    for path in _sources():
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if re.search(pattern, line):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{n}")
    assert not hits, hits
