"""The PyTorch port imports no JAX and nothing of pymodem_tpu, and asks for
CUDA without falling back."""

import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import pymodem_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pymodem_tpu_torch.__path__,
                                               "pymodem_tpu_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print(len(names))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.strip()) >= 20  # every module of the port


_FRONT_DOORS = """
import sys
import pymodem_tpu_torch.cli, pymodem_tpu_torch.serve
assert "torch" not in sys.modules  # the server's client path
import pymodem_tpu_torch.runtime.executor, pymodem_tpu_torch.runtime.bank
from pymodem_tpu_torch.runtime.bank import (run_banked_files,
    run_banked_many, run_plan_banked_many, run_plans_banked_pipelined)
import pymodem_tpu_torch.runtime.stream
from pymodem_tpu_torch import StreamDecoder
assert StreamDecoder is pymodem_tpu_torch.runtime.stream.StreamDecoder
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not any(m == "pymodem_tpu" or m.startswith("pymodem_tpu.")
               for m in sys.modules)
"""


def test_front_doors_import_no_jax():
    """The executor, the streaming decoder, the server and the CLI's batch
    and server routes import no JAX and nothing of pymodem_tpu; the CLI
    and server modules import no torch until a decode runs."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _FRONT_DOORS], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def _port_sources():
    return sorted(glob.glob(os.path.join(REPO, "pymodem_tpu_torch", "**",
                                         "*.py"), recursive=True)
                  + [os.path.join(REPO, "chip_smoke.py")])


def _imported_modules(path):
    """Every module an ``import`` or ``from ... import`` of the file names
    (absolute names only: a relative import stays inside its package)."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


_SYNTH_NO_TORCH = """
import importlib.abc, runpy, sys


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "pymodem_tpu"):
            raise ImportError(f"{name} is not here")


sys.meta_path.insert(0, Refuse())
sys.argv = ["synth", *sys.argv[1:]]
try:
    runpy.run_module("pymodem_tpu_torch.synth", run_name="__main__")
except SystemExit as exc:
    assert exc.code in (0, None), exc.code
import pymodem_tpu_torch.debug, pymodem_tpu_torch.mode
assert "torch" not in sys.modules
"""


def test_synth_cli_and_debug_import_no_torch(tmp_path):
    """``python -m pymodem_tpu_torch.synth`` writes its WAV with torch,
    JAX and pymodem_tpu refused (numpy only, as its JAX original); so do
    ``debug`` and ``mode`` import."""
    import json

    cfg = tmp_path / "fsk_9600.json"
    cfg.write_text(json.dumps({
        "object_name": "fsk", "object_type": "demod_chain",
        "modem": {"type": "fsk", "config": "9600", "options": {}},
        "slicer": {"type": "binary", "config": "9600", "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": "0x63003"}},
        "codec": {"type": "il2p", "options": {"crc": "yes"}}}) + "\n")
    wav = tmp_path / "x.wav"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _SYNTH_NO_TORCH, str(cfg), str(wav),
         "--seconds", "1"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert wav.stat().st_size > 1000 and "frame 0: " in proc.stdout


def test_port_names_nothing_of_pymodem_tpu():
    """No module of the port, and not chip_smoke.py, imports pymodem_tpu
    or any module under it, at any depth of the file."""
    sources = _port_sources()
    assert len(sources) >= 30
    bad = [(os.path.relpath(p, REPO), m) for p in sources
           for m in _imported_modules(p)
           if m == "pymodem_tpu" or m.startswith("pymodem_tpu.")
           or m == "jax" or m.startswith("jax.")]
    assert not bad, bad


_IMPORT_ALONE = """
import importlib, importlib.abc, pkgutil, sys


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("pymodem_tpu", "jax"):
            raise ImportError(f"{name} is not here")


sys.meta_path.insert(0, Refuse())
import chip_smoke
import pymodem_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pymodem_tpu_torch.__path__,
                                               "pymodem_tpu_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def test_port_and_chip_smoke_import_alone(tmp_path):
    """pymodem_tpu_torch/ and chip_smoke.py copied alone into a directory
    import every module there, with pymodem_tpu and jax refused."""
    shutil.copytree(os.path.join(REPO, "pymodem_tpu_torch"),
                    tmp_path / "pymodem_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALONE],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.strip()) >= 25


def test_cuda_request_without_gpu_raises():
    from pymodem_tpu_torch.device import resolve

    assert resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve("cuda")


def test_tf32_off():
    import pymodem_tpu_torch.device  # noqa: F401

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    # the per-backend settings of newer torch versions
    for backend in (torch.backends.cuda.matmul, torch.backends.cudnn):
        if hasattr(backend, "fp32_precision"):
            assert backend.fp32_precision == "ieee"
    if hasattr(torch.backends.cudnn, "conv"):
        assert torch.backends.cudnn.conv.fp32_precision == "ieee"


def test_kernel_wrappers_take_the_twin_only_on_cpu():
    """A CPU tensor runs the plain twin without touching the kernel build;
    another device type raises instead of falling back."""
    from pymodem_tpu_torch.dsp.loops import (
        afsk_pll_lanes,
        nco_cos_table,
        nco_sine_table,
        qpsk_costas_lanes,
    )
    from pymodem_tpu_torch.ops.slicers import (
        binary_slice_lanes,
        four_level_slice_lanes,
    )

    wrappers = (binary_slice_lanes, afsk_pll_lanes, four_level_slice_lanes,
                qpsk_costas_lanes)
    before = [w.launches for w in wrappers]
    x = torch.zeros(2, 16)
    tables = (torch.from_numpy(nco_sine_table()),
              torch.from_numpy(nco_cos_table()))
    binary_slice_lanes(x, torch.ones(2, 2) * 8.0, window=1)
    afsk_pll_lanes(x, torch.zeros(15, 2), tables[0])
    four_level_slice_lanes(x, torch.ones(2, 2) * 8.0, (2, 0, 3, 1), window=2)
    for n_rows in (17, 12):
        qpsk_costas_lanes(x, torch.zeros(n_rows, 2), *tables)
    assert [w.launches for w in wrappers] == before
    meta = torch.zeros(2, 16, device="meta")
    meta_rows = torch.ones(2, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        binary_slice_lanes(meta, meta_rows)
    with pytest.raises(ValueError, match="unsupported device"):
        four_level_slice_lanes(meta, meta_rows, (2, 0, 3, 1))
    with pytest.raises(ValueError, match="unsupported device"):
        qpsk_costas_lanes(meta, torch.zeros(17, 2, device="meta"),
                          *(t.to("meta") for t in tables))
