"""The port's serve mode (server.py) and the ``--server`` client flag:
the cases of tests/test_server.py against the port, on the CPU.

Forwarded requests must write what direct runs write, a bad request must
not kill the server, rc/stdout/stderr round-trip, and ``--warm-k``
reaches ``DeviceCountTable.warm`` once per k on a CUDA device only."""

from __future__ import annotations

import io
import json
import socket
import threading

import pytest

from orion_kmer_tpu_torch import engine, server as srv
from orion_kmer_tpu_torch.cli import _extract_server_flag, main as port_main
from orion_kmer_tpu_torch.version import __version__

from .test_torch_count import port_cpu
from .util import SAMPLE1_FASTA, write_file


def _start(sock, **kwargs):
    ready = threading.Event()
    t = threading.Thread(
        target=srv.serve, args=(sock,), kwargs={"on_ready": ready.set, **kwargs}, daemon=True
    )
    t.start()
    assert ready.wait(60), "server did not come up"
    return t


@pytest.fixture
def running(tmp_path):
    sock = tmp_path / "okt.sock"
    t = _start(sock, device="cpu")
    yield sock
    if t.is_alive():
        srv.forward(sock, ["shutdown"], stdout=io.StringIO(), stderr=io.StringIO())
        t.join(30)
        assert not t.is_alive()


def _fwd(sock, argv):
    out, err = io.StringIO(), io.StringIO()
    rc = srv.forward(sock, argv, stdout=out, stderr=err)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize(
    "argv_of",
    [
        lambda fa, o: ["count", "-k", "5", "-i", fa, "-o", o],
        lambda fa, o: ["sketch", "-k", "7", "--scaled", "2", "-i", fa, "-o", o],
    ],
    ids=["count", "sketch"],
)
def test_request_via_server_matches_direct(running, tmp_path, argv_of):
    fa = str(write_file(tmp_path / "s.fasta", SAMPLE1_FASTA))
    direct = tmp_path / "direct.out"
    assert port_cpu(argv_of(fa, str(direct))) == 0
    # twice: the second request reuses the resident process
    for i in range(2):
        served = tmp_path / f"served{i}.out"
        rc, _, _ = _fwd(running, argv_of(fa, str(served)))
        assert rc == 0
        assert served.read_bytes() == direct.read_bytes()


def test_request_naming_its_device_runs_there(running, tmp_path):
    fa = str(write_file(tmp_path / "s.fasta", SAMPLE1_FASTA))
    rc, _, err = _fwd(running, ["--device", "cuda", "count", "-k", "5", "-i", fa, "-o", str(tmp_path / "o")])
    assert rc == 1 and "no CUDA device" in err  # this host has no card
    rc, _, _ = _fwd(running, ["--device", "cpu", "count", "-k", "5", "-i", fa, "-o", str(tmp_path / "o")])
    assert rc == 0


def test_version_stdout_roundtrip(running):
    rc, out, _ = _fwd(running, ["--version"])
    assert rc == 0
    assert __version__ in out


def test_error_rc_and_stderr_roundtrip(running, tmp_path):
    rc, _, err = _fwd(
        running,
        ["count", "-k", "5", "-i", str(tmp_path / "missing.fa"), "-o", str(tmp_path / "o")],
    )
    assert rc == 1
    assert "[ERROR orion_kmer_tpu]" in err and "missing.fa" in err


def test_usage_error_rc(running):
    rc, _, err = _fwd(running, ["count", "--no-such-flag"])
    assert rc == 2
    assert "usage" in err.lower()


@pytest.mark.parametrize("payload", [b"this is not json\n", b'{"argv": "count"}\n', b"[1, 2]\n"])
def test_bad_request_does_not_kill_server(running, payload):
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(str(running))
    c.sendall(payload)
    reply = json.loads(c.recv(1 << 16).split(b"\n", 1)[0])
    c.close()
    assert reply["rc"] == 2
    rc, out, _ = _fwd(running, ["--version"])  # still serving
    assert rc == 0 and __version__ in out


@pytest.mark.parametrize("prefix", [[], ["--device", "cpu", "-v"]])
def test_nested_serve_refused(running, tmp_path, prefix):
    rc, _, err = _fwd(running, [*prefix, "serve", "--socket", str(tmp_path / "x.sock")])
    assert rc == 2
    assert "cannot nest serve" in err
    assert not (tmp_path / "x.sock").exists()


def test_client_flag_forwarding(running, tmp_path, capsys):
    fa = write_file(tmp_path / "s.fasta", SAMPLE1_FASTA)
    out = tmp_path / "via_flag.tsv"
    rc = port_main(["--server", str(running), "count", "-k", "5", "-i", str(fa), "-o", str(out)])
    assert rc == 0 and out.exists()
    rc = port_main([f"--server={running}", "--version"])
    assert rc == 0
    assert __version__ in capsys.readouterr().out


def test_shutdown_removes_socket(tmp_path):
    sock = tmp_path / "okt.sock"
    t = _start(sock, device="cpu")
    rc, _, _ = _fwd(sock, ["shutdown"])
    assert rc == 0
    t.join(30)
    assert not t.is_alive()
    assert not sock.exists()


def test_forward_no_server(tmp_path):
    rc, _, err = _fwd(tmp_path / "nope.sock", ["--version"])
    assert rc == 1
    assert "no server" in err


def test_extract_server_flag():
    assert _extract_server_flag(["--server", "/s", "count", "-k", "5"]) == (
        "/s",
        ["count", "-k", "5"],
    )
    assert _extract_server_flag(["--server=/s", "--version"]) == ("/s", ["--version"])
    assert _extract_server_flag(["count", "-k", "5"]) == (None, ["count", "-k", "5"])


@pytest.mark.parametrize("device,expected", [("cuda", [5, 21]), ("cpu", [])])
def test_serve_warm_ks_plumbing(tmp_path, monkeypatch, capsys, device, expected):
    """--warm-k reaches DeviceCountTable.warm once per k, before the socket
    is bound, on a CUDA device; on the CPU it is skipped.  warm itself is
    recorded, not run (no card here)."""
    warmed = []
    sock = tmp_path / "warm.sock"

    def warm(self):
        assert not sock.exists()
        warmed.append(self.k)

    monkeypatch.setattr(engine.DeviceCountTable, "warm", warm)
    t = _start(sock, device=device, warm_ks=(5, 21))
    assert warmed == expected
    rc, out, _ = _fwd(sock, ["--version"])
    assert rc == 0 and __version__ in out
    _fwd(sock, ["shutdown"])
    t.join(30)
    assert not t.is_alive()
    assert ("warm-up skipped" in capsys.readouterr().err) == (device == "cpu")


def test_warm_runs_one_batch_and_leaves_the_table_empty(monkeypatch):
    batches = []
    orig = engine.DeviceCountTable.update_packed

    def update_packed(self, *args):
        batches.append(self.k)
        return orig(self, *args)

    monkeypatch.setattr(engine.DeviceCountTable, "update_packed", update_packed)
    table = engine.DeviceCountTable(21, "cpu")
    table.warm()
    assert batches == [21]
    vals, counts = table.result()
    assert vals.shape[0] == 0 and counts.shape[0] == 0
