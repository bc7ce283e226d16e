"""Nothing of the benchmark imports JAX or the JAX package; the reference
imports nothing of the port.  Top-level module names are compared whole:
``pymodem_tpu_torch`` is not ``pymodem_tpu``."""

import ast
import subprocess
import sys

import pytest

from portbench.tests.tiny_bench import ROOT, SRC

FORBIDDEN = {"jax", "jaxlib", "flax", "pymodem_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(SRC.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(SRC)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_reference_and_generator_import_nothing_of_the_port():
    for path in [*(SRC / "reference").rglob("*.py"), *(SRC / "synth").rglob("*.py"),
                 *(SRC / "transmitters").glob("*.py"),
                 SRC / "loadgen.py"] + list((SRC / "roofline").glob("*.py")):
        assert "pymodem_tpu_torch" not in set(_imports(path)), path


def test_loaded_modules_of_the_reference():
    code = ("import sys, importlib, pkgutil, portbench.reference as r, "
            "portbench.transmitters as t, portbench.loadgen\n"
            "for p in (r, t):\n"
            "    for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "        importlib.import_module(m.name)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))  # a list literal printed by the child
    assert not loaded & (FORBIDDEN | {"pymodem_tpu_torch", "torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "pymodem_tpu_torch_fake", object())
    assert "pymodem_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pymodem_tpu.fake", object())
    assert "pymodem_tpu.fake" in harness.forbidden_modules()
