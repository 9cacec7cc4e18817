"""Persistent engine server: one resident process, many CLI requests.

The port of ``orion_kmer_tpu/server.py``, with the same protocol.  A
fresh process pays CUDA context creation, the kernel library's load (an
nvcc build on a fresh checkout) and the first launch of every kernel and
torch op; a resident process pays them once.

Usage:
    python -m orion_kmer_tpu_torch serve --socket /tmp/okt.sock [--warm-k 21 31]   # server
    python -m orion_kmer_tpu_torch --server /tmp/okt.sock count -k 21 ...          # client
    python -m orion_kmer_tpu_torch --server /tmp/okt.sock shutdown                 # stop it

Protocol: one request per SOCK_STREAM unix-socket connection.  The client
sends one JSON line ``{"argv": [...]}``; the server runs the argv through
the port's CLI in-process (same parse, same commands, same error
rendering as a fresh process) on the server's ``--device`` unless the
request names its own, and replies with one JSON line ``{"rc": int,
"stdout": str, "stderr": str}``.  The accept loop is strictly sequential:
one request at a time.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import sys

SHUTDOWN_WORD = "shutdown"

# global CLI options that take a value (cli.build_parser)
_GLOBAL_WITH_VALUE = {"-t", "--threads", "--trace", "--device"}


def _recv_line(conn: socket.socket, limit: int = 64 << 20) -> bytes | None:
    """Read up to the first newline (or EOF); None on empty connection."""
    chunks: list[bytes] = []
    total = 0
    while True:
        data = conn.recv(1 << 16)
        if not data:
            break
        chunks.append(data)
        total += len(data)
        if b"\n" in data:
            break
        if total > limit:
            raise ValueError("request line exceeds limit")
    if not chunks:
        return None
    return b"".join(chunks).split(b"\n", 1)[0]


def _send_reply(conn: socket.socket, reply: dict) -> None:
    conn.sendall(json.dumps(reply).encode() + b"\n")


def _subcommand(argv: list[str]) -> str | None:
    """The subcommand an argv names: its first word after the global
    options."""
    i = 0
    while i < len(argv):
        if argv[i] in _GLOBAL_WITH_VALUE:
            i += 2
        elif argv[i].startswith("-"):
            i += 1
        else:
            return argv[i]
    return None


def run_request(argv: list[str], device: str = "cuda") -> dict:
    """Run one CLI argv in-process on ``device`` (unless the argv names a
    ``--device``), capturing stdout/stderr and rc.

    SystemExit (argparse usage errors, --version, --help) is translated
    to its exit code; any other exception is rendered to the captured
    stderr and mapped to rc 1 so a bad request can never kill the
    server.  Nested ``serve`` is refused (one resident process, not a
    tree of them).
    """
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        if _subcommand(argv) == "serve":
            print("[ERROR orion_kmer_tpu] Error: cannot nest serve", file=sys.stderr)
            rc = 2
        else:
            from .cli import main

            try:
                # a later --device in the request wins over this one
                rc = main(["--device", device, *argv])
            except SystemExit as e:
                code = e.code
                rc = code if isinstance(code, int) else (0 if code is None else 2)
            except Exception:
                import traceback

                traceback.print_exc(file=sys.stderr)
                rc = 1
    return {"rc": rc, "stdout": out.getvalue(), "stderr": err.getvalue()}


def serve(socket_path, device="cuda", warm_ks=(), on_ready=None) -> None:
    """Bind ``socket_path`` and answer requests on ``device`` until
    ``shutdown``.

    ``warm_ks``: on a CUDA device, the count table that requests will use
    (``engine.make_count_table``: one device or sharded) runs its ``warm``
    for each of those k (the kernel library's load and small batches)
    BEFORE the socket is bound, so the socket's existence is the
    readiness signal: a client that can connect never absorbs the warm-up
    into its first request.  On the CPU there is nothing to warm.
    ``on_ready`` fires once listening (tests use it to rendezvous).
    """
    import torch

    device = torch.device(device)
    path = os.fspath(socket_path)
    with contextlib.suppress(FileNotFoundError):
        os.unlink(path)
    if warm_ks:
        if device.type == "cuda":
            from .engine import make_count_table

            for k in warm_ks:
                # the single table or, under ORION_KMER_SHARDS, the sharded one
                make_count_table(int(k), device).warm()
                print(f"[serve] warmed the count path for k={k}", file=sys.stderr)
        else:
            print("[serve] warm-up skipped (CPU device)", file=sys.stderr)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        srv.bind(path)
        srv.listen(8)
        if on_ready is not None:
            on_ready()
        print(f"[serve] listening on {path}", file=sys.stderr, flush=True)
        while True:
            conn, _ = srv.accept()
            with conn:
                try:
                    raw = _recv_line(conn)
                    if raw is None:
                        continue
                    try:
                        argv = json.loads(raw)["argv"]
                        if not isinstance(argv, list):
                            raise TypeError("argv is not a list")
                    except (ValueError, KeyError, TypeError):
                        _send_reply(
                            conn,
                            {"rc": 2, "stdout": "", "stderr": "[serve] bad request\n"},
                        )
                        continue
                    argv = [str(a) for a in argv]
                    if argv == [SHUTDOWN_WORD]:
                        _send_reply(conn, {"rc": 0, "stdout": "", "stderr": ""})
                        break
                    _send_reply(conn, run_request(argv, device.type))
                except (BrokenPipeError, ConnectionError):
                    continue  # client went away mid-reply; keep serving
    finally:
        srv.close()
        with contextlib.suppress(OSError):
            os.unlink(path)


def forward(socket_path, argv, stdout=None, stderr=None) -> int:
    """Send one argv to a running server; relay its stdout/stderr; return rc.

    No socket timeout on purpose: a forwarded ``count`` over a large
    input legitimately runs for minutes to hours.
    """
    path = os.fspath(socket_path)
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        try:
            c.connect(path)
        except (FileNotFoundError, ConnectionRefusedError) as e:
            print(
                f"[ERROR orion_kmer_tpu] Error: no server at {path}: {e}",
                file=stderr or sys.stderr,
            )
            return 1
        c.sendall(json.dumps({"argv": [str(a) for a in argv]}).encode() + b"\n")
        chunks = []
        while True:
            data = c.recv(1 << 16)
            if not data:
                break
            chunks.append(data)
    finally:
        c.close()
    line = b"".join(chunks).split(b"\n", 1)[0]
    if not line:
        print(
            f"[ERROR orion_kmer_tpu] Error: empty reply from server at {path}",
            file=stderr or sys.stderr,
        )
        return 1
    rep = json.loads(line)
    (stdout or sys.stdout).write(rep["stdout"])
    (stderr or sys.stderr).write(rep["stderr"])
    return int(rep["rc"])


def run_serve(args, device) -> None:
    """Dispatch target for the ``serve`` subcommand."""
    serve(args.socket, device, warm_ks=args.warm_k)
