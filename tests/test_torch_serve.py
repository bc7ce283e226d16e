"""The port's CLI batch routes and decode server against the direct CLI and
the JAX package's CLI text, on the CPU (``PYMODEM_TPU_TORCH_DEVICE=cpu``).

Output is compared with the ``Elapsed time`` line stripped: a server
round trip equals the port's direct CLI and the JAX package's; a batch
across two configs (``cli.run_decode_batch``) equals the JAX package's
batch and the one-at-a-time runs; a batch that prints a diagnostic or
raises degrades to one-at-a-time runs; the client path imports no torch.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from pymodem_tpu_torch.synth import fixtures as tfx
from pymodem_tpu_torch.synth import modulate as tmod
from pymodem_tpu_torch.wav_io import write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE = 8000


def _line(name, codec, invert):
    return {
        "object_name": name, "object_type": "demod_chain",
        "modem": {"type": "afsk", "config": "1200", "options": {}},
        "slicer": {"type": "binary", "config": "1200", "options": {}},
        "stream": {"type": "lfsr", "options": {"poly": "0x3",
                                               "invert": invert}},
        "codec": {"type": codec, "options": {"crc": "yes"}},
    }


REPORT = {"object_name": "report", "object_type": "report",
          "options": {"style": "decoded_headers", "destination": "std_out"}}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two configs (AFSK-1200 IL2P+CRC, AFSK-1200 AX.25) and a WAV of 2
    frames for each, 8 kHz int16."""
    d = tmp_path_factory.mktemp("serve")
    out = {}
    for key, codec, invert in (("il2p", "il2p", "no"),
                               ("ax25", "ax25", "yes")):
        cfg = d / f"{key}.json"
        cfg.write_text(json.dumps(_line(f"AFSK 1200 {key}", codec, invert))
                       + "\n" + json.dumps(REPORT) + "\n")
        rng = np.random.default_rng(20261103)
        sent = tfx.payloads(rng, count=2, size=16)
        bits = (tfx.il2p_line_bits(sent, 0x3, False) if codec == "il2p"
                else tfx.ax25_line_bits(sent, 0x3, True))
        wav = d / f"{key}.wav"
        write_wav(str(wav), RATE, tmod.to_int16(
            tmod.afsk_modulate(bits, float(RATE), 1200.0, 1200.0, 2200.0)))
        out[key] = (str(cfg), str(wav), sent)
    return out


def _strip(text: str) -> str:
    return re.sub(r"Elapsed time: [0-9.]+ seconds\.", "Elapsed time: X", text)


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, PYMODEM_TPU_TORCH_DEVICE="cpu")
    env.pop("PYMODEM_TPU_TORCH_SERVER", None)
    env.update(extra)
    return env


def _cli(module, *args, env):
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)


_JAX_BATCH = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
from pymodem_tpu.cli import run_decode_batch
print(json.dumps(run_decode_batch(json.loads(sys.argv[1]))))
"""


def _jax_batch(requests):
    proc = subprocess.run([sys.executable, "-c", _JAX_BATCH,
                           json.dumps(requests)], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return [tuple(r) for r in json.loads(proc.stdout.strip().splitlines()[-1])]


class _Server:
    """``python -m pymodem_tpu_torch.serve`` in a subprocess, its output
    in a file (an undrained pipe could block it)."""

    def __init__(self, tmp_path, **env):
        self.sock = str(tmp_path / "port.sock")
        self.log = tmp_path / "server.log"
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "pymodem_tpu_torch.serve", self.sock],
            cwd=REPO, env=_env(**env), stdout=open(self.log, "w"),
            stderr=subprocess.STDOUT)
        for _ in range(600):
            if os.path.exists(self.sock):
                return
            if self.proc.poll() is not None:
                break
            time.sleep(0.1)
        self.stop()
        raise AssertionError(self.log.read_text()[-2000:])

    def stop(self):
        from pymodem_tpu_torch.serve import client_shutdown

        try:
            if self.proc.poll() is None and os.path.exists(self.sock):
                client_shutdown(self.sock)
            self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()


def test_server_roundtrip(tmp_path, files):
    cfg, wav, sent = files["il2p"]
    direct = _cli("pymodem_tpu_torch", cfg, wav, env=_env())
    assert direct.returncode == 0, direct.stderr[-2000:]
    assert f"Unique, valid packets:  {len(sent)}\n" in direct.stdout
    ref = _cli("pymodem_tpu", cfg, wav, env=_env(PYMODEM_TPU_PLATFORM="cpu"))
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert _strip(direct.stdout) == _strip(ref.stdout)

    server = _Server(tmp_path)
    try:
        cenv = _env(PYMODEM_TPU_TORCH_SERVER=server.sock)
        first = _cli("pymodem_tpu_torch", cfg, wav, env=cenv)
        second = _cli("pymodem_tpu_torch", cfg, wav, env=cenv)
        assert first.returncode == second.returncode == 0, first.stdout
        assert _strip(first.stdout) == _strip(second.stdout) == \
            _strip(direct.stdout)
        # exit codes pass through the server
        bad = _cli("pymodem_tpu_torch", cfg, "/nonexistent.wav", env=cenv)
        assert bad.returncode == 4, bad.stdout
        assert bad.stdout == "Unable to open audio file.\n"
    finally:
        server.stop()
    assert server.proc.returncode == 0


def test_server_batches_queued_requests(tmp_path, files):
    """Three requests queued together (two configs, one unreadable WAV),
    drained into one batch by the accept window: each answer equals the
    one-shot run's."""
    from pymodem_tpu_torch.serve import client_request

    requests = [files["il2p"][:2], files["ax25"][:2],
                (files["il2p"][0], "/nonexistent.wav")]
    server = _Server(tmp_path, PYMODEM_TPU_TORCH_SERVE_BATCH_WINDOW="2.0")
    answers = [None] * len(requests)
    try:
        def ask(i):
            answers[i] = client_request(server.sock, *requests[i])

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
            time.sleep(0.2)
        for t in threads:
            t.join(timeout=600)
    finally:
        server.stop()
    for (cfg, wav), (code, output) in zip(requests, answers):
        direct = _cli("pymodem_tpu_torch", cfg, wav, env=_env())
        assert code == direct.returncode
        assert _strip(output) == _strip(direct.stdout)


def _batch_requests(files):
    return [files["il2p"][:2], files["ax25"][:2], files["il2p"][:2],
            (files["ax25"][0], "/nonexistent.wav")]


def test_run_decode_batch_matches_jax_and_one_shot(files, monkeypatch,
                                                   capsys):
    from pymodem_tpu_torch import cli

    monkeypatch.setenv("PYMODEM_TPU_TORCH_DEVICE", "cpu")
    requests = _batch_requests(files)
    got = cli.run_decode_batch(requests)
    want = _jax_batch(requests)
    assert [(c, _strip(o)) for c, o in got] == \
        [(c, _strip(o)) for c, o in want]
    one_shot = []
    for cfg, wav in requests:
        code = cli.run_decode(cfg, wav)
        one_shot.append((code, capsys.readouterr().out))
    assert [(c, _strip(o)) for c, o in got] == \
        [(c, _strip(o)) for c, o in one_shot]
    assert [c for c, _ in got] == [0, 0, 0, 4]
    for (_, wav, sent), (_, out) in zip(
            (files["il2p"], files["ax25"]), got):
        assert f"Unique, valid packets:  {len(sent)}\n" in out
    # several recordings of one config
    cfg, wav, _ = files["il2p"]
    many = cli.run_decode_many(cfg, [wav, "/nonexistent.wav", wav])
    assert [(c, _strip(o)) for c, o in many] == \
        [one_shot[0][:1] + (_strip(one_shot[0][1]),),
         (4, "Unable to open audio file.\n")] + \
        [one_shot[0][:1] + (_strip(one_shot[0][1]),)]


@pytest.mark.parametrize("failure", ["diagnostic", "exception"])
def test_run_decode_batch_degrades(files, monkeypatch, failure):
    """A pipelined batch that prints a diagnostic (as a resilient retry
    does) or raises is run again one request at a time: the answers equal
    the one-shot runs', and the diagnostic reaches no client."""
    from pymodem_tpu_torch import cli
    from pymodem_tpu_torch.runtime import bank

    monkeypatch.setenv("PYMODEM_TPU_TORCH_DEVICE", "cpu")
    requests = _batch_requests(files)
    want = cli.run_decode_batch(requests)
    real = bank.run_plans_banked_pipelined
    calls = []

    def noisy(*a, **kw):
        calls.append(1)
        if failure == "exception":
            raise RuntimeError("injected batch failure")
        print("banked runtime failed (injected); retrying chains "
              "sequentially")
        return real(*a, **kw)

    monkeypatch.setattr(bank, "run_plans_banked_pipelined", noisy)
    got = cli.run_decode_batch(requests)
    assert calls == [1]
    assert [(c, _strip(o)) for c, o in got] == \
        [(c, _strip(o)) for c, o in want]
    assert not any("injected" in o for _, o in got)


_CLIENT_WITHOUT_TORCH = """
import importlib.abc, sys


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("torch", "jax", "numpy"):
            raise ImportError(f"{name} refused")


sys.meta_path.insert(0, Refuse())
from pymodem_tpu_torch.cli import main
code = main(["prog", sys.argv[1], sys.argv[2]])
assert "torch" not in sys.modules
sys.exit(code)
"""


def test_client_path_imports_no_torch(tmp_path, files):
    cfg, wav, sent = files["il2p"]
    server = _Server(tmp_path)
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _CLIENT_WITHOUT_TORCH, cfg, wav],
            cwd=REPO, env=_env(PYMODEM_TPU_TORCH_SERVER=server.sock),
            capture_output=True, text=True, timeout=600)
    finally:
        server.stop()
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"Unique, valid packets:  {len(sent)}\n" in proc.stdout


def test_runtime_names(monkeypatch):
    from pymodem_tpu_torch import cli

    for value, want in (("", "banked"), ("auto", "banked"),
                        ("banked", "banked"), ("sequential", "sequential")):
        monkeypatch.setenv("PYMODEM_TPU_TORCH_RUNTIME", value)
        if not value:
            monkeypatch.delenv("PYMODEM_TPU_TORCH_RUNTIME")
        assert cli.runtime_name() == want


@pytest.mark.parametrize("runtime", ["sequential", "banked"])
def test_cli_runtime_and_profile(files, monkeypatch, capsys, tmp_path,
                                 runtime):
    """PYMODEM_TPU_TORCH_RUNTIME picks the runtime (its report equal to the
    other's); PYMODEM_TPU_TORCH_PROFILE adds the stage table, and a path
    value a torch.profiler trace."""
    from pymodem_tpu_torch import cli, profiling

    cfg, wav, sent = files["ax25"]
    monkeypatch.setenv("PYMODEM_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("PYMODEM_TPU_TORCH_RUNTIME", runtime)
    monkeypatch.setenv("PYMODEM_TPU_TORCH_PROFILE", str(tmp_path / "trace"))
    profiling.reset()
    try:
        assert cli.main(["prog", cfg, wav]) == 0
    finally:
        profiling.enable(False)
        profiling.reset()
    out = capsys.readouterr().out
    assert f"Unique, valid packets:  {len(sent)}\n" in out
    first = ("AFSK 1200 ax25 chain start\n" if runtime == "sequential"
             else "banked runtime: 1 chains\n")
    assert out.splitlines(keepends=True)[1] == first
    assert os.path.exists(tmp_path / "trace" / "trace.json")
    if runtime == "banked":
        assert "stage timings:" in out
