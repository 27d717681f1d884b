"""The port's persistent reconstruction service (recon3d_tpu_torch/
runtime/serve.py) end to end over a real daemon process on the CPU, as
tests/test_serve.py drives the JAX one, plus the three faults the JAX
daemon has (ADVICE.md, round 5) that the port's must not:

  - a client that goes away mid-job took the daemon down (BrokenPipe on
    its replies);
  - a busy daemon could not answer a ping, so a second daemon took its
    socket;
  - a client that connected and sent nothing wedged the daemon.

The daemon runs with --device cpu and a 0.5 s read timeout; a request
without --device runs on the daemon's device.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from recon3d_tpu_torch.io.ply import load_ply
from recon3d_tpu_torch.runtime import serve
from tests.render import render_views

REPO = Path(__file__).resolve().parent.parent
READ_TIMEOUT_S = 0.5


def _socket_path() -> str:
    """A short unique socket path (AF_UNIX paths cap at ~107 bytes)."""
    d = tempfile.gettempdir()
    if len(d) > 60:
        d = "/tmp"
    return os.path.join(d, f"r3dt_{uuid.uuid4().hex[:8]}.sock")


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    return env


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("srv_imgs")
    scene = render_views(n_views=5, image_size=(128, 160), arc_step=0.15)
    for i, img in enumerate(scene["images"]):
        Image.fromarray((img * 255).astype(np.uint8)).save(d / f"im_{i:03d}.png")
    return str(d)


@pytest.fixture(scope="module")
def server():
    sock = _socket_path()
    proc = subprocess.Popen(
        [sys.executable, "-m", "recon3d_tpu_torch.runtime.serve", "--socket", sock,
         "--quiet", "--device", "cpu", "--read-timeout", str(READ_TIMEOUT_S)],
        env=_env(), cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True,
    )
    deadline = time.time() + 120
    while time.time() < deadline and not serve.ping(sock, timeout=1.0):
        if proc.poll() is not None:
            raise RuntimeError(f"server died on startup: {proc.stderr.read()}")
        time.sleep(0.2)
    assert serve.ping(sock), "server never came up"
    yield sock
    serve.shutdown(sock)
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
    assert not os.path.exists(sock), "the daemon left its socket behind"


def _pong(sock: str) -> dict:
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(30.0)
        s.connect(sock)
        serve._send(s, {"ping": True})
        return json.loads(s.makefile("r").readline())


@pytest.mark.slow
def test_serve_two_requests_second_is_steady_state(server, image_dir, tmp_path):
    """Request 1 warms the daemon; request 2 completes a dense --mvs job
    through the same process. Both produce valid clouds; the second is
    faster; the daemon survives both."""
    logs1, logs2 = [], []
    out1, out2 = tmp_path / "r1", tmp_path / "r2"
    stats2 = tmp_path / "stats2.json"

    t0 = time.time()
    rc = serve.request([image_dir, "--mvs", "--output", str(out1), "--seed", "1"],
                       server, on_log=logs1.append)
    t_cold = time.time() - t0
    assert rc == 0, "\n".join(logs1[-20:])
    pts1, _ = load_ply(str(out1 / "sparse.ply"))
    assert len(pts1) > 100

    t0 = time.time()
    rc = serve.request([image_dir, "--mvs", "--output", str(out2), "--seed", "1",
                        "--stats-json", str(stats2)], server, on_log=logs2.append)
    t_warm = time.time() - t0
    assert rc == 0, "\n".join(logs2[-20:])
    pts2, _ = load_ply(str(out2 / "sparse.ply"))
    assert len(pts2) > 100
    assert (out2 / "dense_mvs.ply").exists()
    s = json.loads(stats2.read_text())
    assert s["num_cameras"] >= 4 and s["device"] == "cpu"
    assert t_warm < t_cold, (t_cold, t_warm)
    assert serve.ping(server)


def test_serve_bad_request_keeps_daemon_alive(server):
    logs = []
    rc = serve.request(["definitely/not/a/dir", "--fast"], server, on_log=logs.append)
    assert rc != 0
    assert any("not found" in line for line in logs), logs
    rc = serve.request(["--no-such-flag"], server)
    assert rc == 2
    assert serve.ping(server), "daemon died on a bad request"


def test_serve_worker_routes_through_service(server, image_dir, tmp_path):
    """The worker's serve_socket option routes a job through the daemon,
    with log streaming and status sniffing intact."""
    from recon3d_tpu_torch.runtime.worker import ReconstructionWorker

    logs, statuses, finished = [], [], []
    w = ReconstructionWorker(on_log=logs.append, on_status=statuses.append,
                             on_finished=finished.append)
    ok = w.run(image_dir, {
        "method": "custom",
        "output": str(tmp_path / "w_out"),
        "serve_socket": server,
        "serve_autostart": False,
    })
    assert ok and finished == [True], "\n".join(logs[-20:])
    assert (tmp_path / "w_out" / "sparse.ply").exists()
    assert any("Step" in s for s in statuses)
    assert any("sparse.ply" in line for line in logs)


def test_request_without_device_runs_on_the_daemons(server, image_dir, tmp_path):
    """An argv without --device gets the daemon's (here the CPU; a CUDA
    default would raise on this host); one with --device keeps its own."""
    stats = tmp_path / "stats.json"
    logs = []
    rc = serve.request([image_dir, "--fast", "--max-images", "3", "--output",
                        str(tmp_path / "o"), "--stats-json", str(stats)],
                       server, on_log=logs.append)
    assert rc == 0, "\n".join(logs[-20:])
    assert json.loads(stats.read_text())["device"] == "cpu"
    assert any("on cpu" in line for line in logs)
    if not torch.cuda.is_available():
        logs = []
        rc = serve.request([image_dir, "--fast", "--device", "cuda"], server,
                           on_log=logs.append)
        assert rc == 1 and any("is_available() is False" in line for line in logs)
        assert serve.ping(server)


def test_ping_on_dead_socket():
    assert not serve.ping("/tmp/r3d_nothing_here.sock", timeout=0.5)
    assert serve.probe("/tmp/r3d_nothing_here.sock", timeout=0.5) == "dead"
    with pytest.raises(ConnectionError):
        serve.request(["x"], "/tmp/r3d_nothing_here.sock")


# -- the three faults ---------------------------------------------------------


def test_client_closing_mid_request_leaves_the_daemon_alive(server, image_dir, tmp_path):
    """A client that sends a job and closes at once: every reply of the
    job (its logs, its terminal `done`) goes to a closed socket; the
    daemon finishes the job, counts it and answers the next ping."""
    served = _pong(server)["requests_served"]
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(server)
        serve._send(s, {"argv": [image_dir, "--fast", "--max-images", "3",
                                 "--output", str(tmp_path / "gone")]})
    deadline = time.time() + 120
    while time.time() < deadline:
        pong = _pong(server)
        if pong["requests_served"] > served:
            break
        time.sleep(0.2)
    assert pong["pong"] and pong["requests_served"] == served + 1
    assert (tmp_path / "gone" / "sparse.ply").exists()


def test_handle_survives_a_closed_peer_in_process(tmp_path):
    """The same fault without timing: the peer closes before the daemon
    reads. A ping, a bad request and a job all return normally."""
    srv = serve.ReconstructionServer(str(tmp_path / "unused.sock"), quiet=True, device="cpu")
    for req in ({"ping": True}, {"argv": "not a list"}, {"argv": ["definitely/not/a/dir"]}):
        a, b = socket.socketpair()
        serve._send(b, req)
        b.close()
        with a:
            assert srv._handle(a) is True
    assert srv.requests_served == 1


def test_silent_client_is_dropped(server):
    """A connection that sends nothing is closed after the read timeout and
    the daemon goes on to the next."""
    dropped = _pong(server)["dropped"]
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(30.0)
        s.connect(server)
        t0 = time.time()
        assert s.recv(1) == b""           # the daemon closed it
        waited = time.time() - t0
    assert READ_TIMEOUT_S * 0.9 <= waited < 10.0, waited
    pong = _pong(server)
    assert pong["dropped"] == dropped + 1


def test_busy_listener_is_not_stolen_and_stale_file_is(tmp_path):
    """A listener that accepts but does not answer (a daemon busy with a
    job) is "busy": a second daemon refuses to bind there and
    ensure_server spawns none. A file left by a dead daemon (connect()
    refused) is "dead": a daemon takes it over."""
    path = _socket_path()
    busy = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    busy.bind(path)
    busy.listen(4)
    try:
        inode = os.stat(path).st_ino
        assert serve.probe(path, timeout=0.5) == "busy"
        assert not serve.ping(path, timeout=0.5)
        srv = serve.ReconstructionServer(path, quiet=True, device="cpu")
        with pytest.raises(RuntimeError, match="another server is live"):
            srv.bind()
        t0 = time.time()
        assert serve.ensure_server(path, spawn_timeout=5.0, device="cpu") is True
        assert time.time() - t0 < 5.0
        assert os.stat(path).st_ino == inode      # still the busy listener's
        busy.settimeout(1.0)
        conn, _ = busy.accept()                     # the probes wait in its backlog
        conn.close()
    finally:
        busy.close()
        with contextlib.suppress(FileNotFoundError):
            os.unlink(path)

    stale = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    stale.bind(path)
    stale.close()                                   # the file stays, nobody listens
    assert os.path.exists(path)
    assert serve.probe(path, timeout=0.5) == "dead"
    srv = serve.ReconstructionServer(path, quiet=True, device="cpu")
    srv.bind()
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.connect(path)                         # the new daemon listens there
    finally:
        srv.close()
    assert not os.path.exists(path)


def test_second_daemon_refuses_while_the_first_is_busy(image_dir, tmp_path):
    """A daemon held busy (here by a client that has connected and not yet
    sent its request, with a 60 s read timeout) does not answer a ping: a
    second daemon on its socket exits with "another server is live
    (busy)", and ensure_server spawns none. The first then serves that
    client's job and answers."""
    sock = _socket_path()
    proc = subprocess.Popen(
        [sys.executable, "-m", "recon3d_tpu_torch.runtime.serve", "--socket", sock,
         "--quiet", "--device", "cpu", "--read-timeout", "60"],
        env=_env(), cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while not serve.ping(sock, timeout=1.0):
            assert proc.poll() is None and time.time() < deadline, proc.stderr.read()
            time.sleep(0.2)
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as held:
            held.connect(sock)
            assert serve.probe(sock, timeout=0.5) == "busy"
            r = subprocess.run([sys.executable, "-m", "recon3d_tpu_torch.serve", "--socket",
                                sock, "--device", "cpu"], env=_env(), cwd=str(REPO),
                               capture_output=True, text=True, timeout=120)
            assert r.returncode == 1, r.stderr
            assert "another server is live" in r.stderr and "(busy)" in r.stderr, r.stderr
            assert serve.ensure_server(sock, spawn_timeout=5.0, device="cpu") is True
            serve._send(held, {"argv": [image_dir, "--fast", "--max-images", "3",
                                        "--output", str(tmp_path / "held")]})
            replies = [json.loads(line) for line in held.makefile("r")]
        assert replies[-1] == {"done": True, "exit_code": 0}
        assert (tmp_path / "held" / "sparse.ply").exists()
        pong = _pong(sock)
        assert pong["requests_served"] == 1
    finally:
        serve.shutdown(sock)
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
    assert not os.path.exists(sock)


def test_daemon_refuses_a_missing_gpu():
    """Without --device cpu the daemon asks for CUDA: on a host without a
    GPU it exits non-zero with resolve_device's message and leaves no
    socket."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    sock = _socket_path()
    r = subprocess.run([sys.executable, "-m", "recon3d_tpu_torch.serve", "--socket", sock],
                       env=_env(), cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert "torch.cuda.is_available() is False" in r.stderr and "--device cpu" in r.stderr
    assert not os.path.exists(sock)
