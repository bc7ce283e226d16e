"""Persistent decode server: the CLI's warm pool.

A one-shot CLI process pays, before its first sample, for the CUDA context,
loading the kernel library (and building it if the sources changed),
cuBLAS handles and the device codec's budget sizing (two readbacks a codec
call until its budget cache is warm).  This server keeps one process whose
context, library, handles and budget cache persist across requests.

    # start once (stays in the foreground; & to background it)
    python -m pymodem_tpu_torch.serve /tmp/pymodem_torch.sock

    # every CLI call now goes through the warm process
    PYMODEM_TPU_TORCH_SERVER=/tmp/pymodem_torch.sock \
        python -m pymodem_tpu_torch <config.json> <audio.wav>

Protocol (the JAX package's ``pymodem_tpu.serve``): one JSON request line
per connection over a unix socket, ``{"config": <abs path>, "wav": <abs
path>}``, answered by one JSON line ``{"code": <exit code>, "output":
<captured stdout>}``.  ``{"op": "shutdown"}`` stops the server.

Queued requests pipeline: after accepting one request the server drains
the connections already waiting (an accept window of
PYMODEM_TPU_TORCH_SERVE_BATCH_WINDOW seconds, default 0.05, up to
MAX_BATCH requests) and decodes the batch, across config files too,
through ``cli.run_decode_batch`` (``bank.run_plans_banked_pipelined``).  A
single request takes the one-shot path, its output equal to the direct
CLI's.  A client that connects and sends nothing is dropped after a
timeout.  This module imports no torch: the client side runs in the CLI's
process.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import sys
import traceback

MAX_BATCH = 16


def client_request(sock_path: str, config: str, wav: str,
                   timeout: float = 3600.0) -> tuple[int, str]:
    """Send one decode request to a running server; returns (code, output)."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(sock_path)
        req = {"config": os.path.abspath(config), "wav": os.path.abspath(wav)}
        s.sendall((json.dumps(req) + "\n").encode())
        with s.makefile("r") as f:
            resp = json.loads(f.readline())
    return int(resp["code"]), resp["output"]


def client_shutdown(sock_path: str) -> None:
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(sock_path)
        s.sendall(b'{"op": "shutdown"}\n')
        with s.makefile("r") as f:
            f.readline()


def _read_request(conn, timeout: float = 10.0):
    """Read one request line; a connected but silent client must not hold
    the drained batch (or the server) hostage."""
    conn.settimeout(timeout)
    try:
        with conn.makefile("r") as f:
            line = f.readline()
    except (socket.timeout, OSError):
        return None
    finally:
        conn.settimeout(None)
    if not line.strip():
        return None
    try:
        return json.loads(line)
    except json.JSONDecodeError:
        conn.sendall(b'{"code": 1, "output": "bad request"}\n')
        return None


def _respond(conn, code: int, output: str) -> None:
    try:
        conn.sendall((json.dumps({"code": code, "output": output})
                      + "\n").encode())
    except OSError:
        pass  # the client gave up; keep serving
    finally:
        conn.close()


def _decode_one(config: str, wav: str) -> tuple[int, str]:
    from .cli import run_decode

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            code = run_decode(config, wav)
        except SystemExit as exc:  # defensive: the CLI returns its codes
            code = int(exc.code or 0)
        except Exception:  # noqa: BLE001 - reported to the client
            traceback.print_exc(file=buf)
            code = 1
    return code, buf.getvalue()


def _serve_batch(batch) -> None:
    """Decode a drained batch as one pipelined unit (cli.run_decode_batch);
    a single request takes the one-shot path."""
    from .cli import run_decode_batch

    if len(batch) == 1:
        conn, req = batch[0]
        _respond(conn, *_decode_one(req["config"], req["wav"]))
        return
    try:
        results = run_decode_batch(
            [(req["config"], req["wav"]) for _, req in batch])
    except Exception:  # noqa: BLE001 - retry one at a time
        results = None
    if results is None:
        for conn, req in batch:
            _respond(conn, *_decode_one(req["config"], req["wav"]))
        return
    for (conn, _req), (code, output) in zip(batch, results):
        _respond(conn, code, output)


def serve(sock_path: str) -> int:
    """Run the decode server until a shutdown request.  Blocks."""
    try:
        os.unlink(sock_path)
    except FileNotFoundError:
        pass
    window = float(os.environ.get("PYMODEM_TPU_TORCH_SERVE_BATCH_WINDOW",
                                  "0.05"))
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(MAX_BATCH)
    print(f"pymodem_tpu_torch decode server listening on {sock_path}",
          flush=True)
    try:
        while True:
            srv.settimeout(None)
            conn, _ = srv.accept()
            batch = []
            shutdown_conn = None
            req = _read_request(conn)
            if req is None:
                conn.close()
                continue
            if req.get("op") == "shutdown":
                shutdown_conn = conn
            else:
                batch.append((conn, req))
                # drain the requests already queued into one batch
                srv.settimeout(window)
                while len(batch) < MAX_BATCH and shutdown_conn is None:
                    try:
                        c2, _ = srv.accept()
                    except socket.timeout:
                        break
                    r2 = _read_request(c2)
                    if r2 is None:
                        c2.close()
                    elif r2.get("op") == "shutdown":
                        shutdown_conn = c2
                    else:
                        batch.append((c2, r2))
            if batch:
                _serve_batch(batch)
            if shutdown_conn is not None:
                _respond(shutdown_conn, 0, "bye")
                return 0
    finally:
        srv.close()
        try:
            os.unlink(sock_path)
        except FileNotFoundError:
            pass


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    if len(argv) != 2:
        print("Usage: python -m pymodem_tpu_torch.serve <socket path>")
        return 2
    return serve(argv[1])


if __name__ == "__main__":
    raise SystemExit(main())
