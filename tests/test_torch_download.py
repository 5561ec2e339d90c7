"""The port's photo downloader (umpr_tpu_torch/data/download.py) against
the JAX package's, both against one local HTTP server: success,
retry-then-success, a permanent failure and a valid file left untouched
give the same files byte for byte, the same requests per URL and the same
``done:`` line.  Importing the port's module leaves the process's socket
timeout and urllib opener as they were."""

import json
import socket
import subprocess
import sys
import threading
import urllib.request
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import pytest

from umpr_tpu.data import download as jdownload
from umpr_tpu_torch.data import download

REPO = Path(__file__).resolve().parents[1]
OLD = b"\xff\xd8 old \xff\xd9"


def _serve():
    """A server of /good.jpg, /big.jpg, /flaky.jpg (503 at every odd
    request) and 404 elsewhere; -> (server, base URL, hit counter)."""
    hits = Counter()
    bodies = {"/good.jpg": b"\xff\xd8 jpeg body \xff\xd9",
              "/big.jpg": b"\xff\xd8" + bytes(range(256)) * 64 + b"\xff\xd9",
              "/flaky.jpg": b"\xff\xd8 flaky body \xff\xd9"}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            hits[self.path] += 1
            body = bodies.get(self.path)
            if body is None or (self.path == "/flaky.jpg" and hits[self.path] % 2 == 1):
                self.send_error(404 if body is None else 503)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}", hits


def _manifest(root, base):
    root.mkdir()
    rows = [("good", "good.jpg"), ("big", "big.jpg"), ("flaky", "flaky.jpg"),
            ("gone", "missing.jpg"), ("have", "missing.jpg")]
    with open(root / "photos.json", "w") as f:
        for i, (pid, name) in enumerate(rows):
            f.write(json.dumps({"business_id": f"I{i}", "photo_id": pid,
                                "imUrl": f"{base}/{name}"}) + "\n")
    (root / "photos").mkdir()
    (root / "photos" / "have.jpg").write_bytes(OLD)  # valid: skipped although it 404s
    return root / "photos.json"


@pytest.fixture
def restore_net_state():
    timeout, opener = socket.getdefaulttimeout(), urllib.request._opener
    yield
    socket.setdefaulttimeout(timeout)
    urllib.request.install_opener(opener)


def test_downloaders_agree(tmp_path, capsys, monkeypatch, restore_net_state):
    srv, base, hits = _serve()
    try:
        runs = {}
        for name, mod in (("jax", jdownload), ("port", download)):
            pj = _manifest(tmp_path / name, base)
            monkeypatch.setattr(mod.download_photo, "__defaults__", (3,))  # fewer tries
            hits.clear()
            capsys.readouterr()
            mod.download_photos(str(pj))
            out = capsys.readouterr().out
            files = {p.name: p.read_bytes() for p in sorted((pj.parent / "photos").iterdir())}
            done = [ln.rsplit("(", 1)[0] for ln in out.splitlines() if ln.startswith("done:")]
            failed = sorted(ln.replace(name, "X") for ln in out.splitlines()
                            if ln.startswith("FAILED:"))
            runs[name] = files, dict(hits), done, failed
            assert socket.getdefaulttimeout() == 20
            ua = dict(urllib.request._opener.addheaders)["User-agent"]
            assert ua.startswith("Mozilla/5.0")
    finally:
        srv.shutdown()
    assert runs["port"] == runs["jax"]
    files, hit, done, failed = runs["port"]
    assert done == ["done: 3 ok, 1 failed "]
    assert hit == {"/good.jpg": 1, "/big.jpg": 1, "/flaky.jpg": 2, "/missing.jpg": 3}
    assert files["have.jpg"] == OLD and len(failed) == 1
    assert all(download.is_valid_jpg(str(tmp_path / "port" / "photos" / f"{n}.jpg"))
               for n in ("good", "big", "flaky"))


def test_missing_manifest_prints_the_hint(tmp_path, capsys, restore_net_state):
    for mod in (jdownload, download):
        mod.download_photos(str(tmp_path / "photos.json"))
    out = capsys.readouterr().out.splitlines()
    hint = "no photos.json found -- run the preprocessor first to generate it"
    assert out.count(hint) == 2


def test_import_leaves_socket_and_urllib_state():
    code = ("import socket, urllib.request\n"
            "before = socket.getdefaulttimeout(), urllib.request._opener\n"
            "import umpr_tpu_torch.data.download as d\n"
            "assert (socket.getdefaulttimeout(), urllib.request._opener) == before\n"
            "assert d.is_valid_jpg('/nonexistent') is False\n"
            "print(before[0], before[1])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["None", "None"]
