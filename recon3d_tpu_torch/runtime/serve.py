"""Persistent reconstruction service (PyTorch port of
recon3d_tpu/runtime/serve.py).

A fresh CLI process pays for its interpreter, the torch import, the CUDA
context, K1's library load and the lazy module loads before its first
stage runs. This daemon pays them once: it holds the device warm and runs
CLI requests in-process, one at a time, streaming their stdout to the
client.

Protocol (newline-delimited JSON over a Unix domain socket):

  client -> server   {"argv": ["<dataset>", "--mvs", ...]}
                     {"ping": true}
                     {"shutdown": true}
  server -> client   {"log": "<one stdout line>"}      (zero or more)
                     {"done": true, "exit_code": 0}    (terminal)
                     {"pong": true, ...}               (ping reply)

Requests are handled one at a time (one device); queued connections wait
in the listen backlog. A request whose argv carries no --device runs on the
daemon's device.

The daemon survives its clients:
  - every reply to a connection is guarded: a client that goes away
    mid-job costs its replies, never the daemon;
  - a connection must send its request line within `read_timeout` seconds
    (default 10), else it is dropped and the loop goes on;
  - a socket path is taken over only when it is dead (connect() refused or
    the path missing). A daemon that accepts the connection but does not
    answer in time is busy, and a second daemon refuses to start there
    ("another server is live"); ensure_server does not spawn one.

Run the daemon:   python -m recon3d_tpu_torch.runtime.serve --socket S [--device cpu]
Submit a job:     python -m recon3d_tpu_torch.runtime.serve --socket S \\
                      --submit <dataset> --mvs --output out/
Stop it:          python -m recon3d_tpu_torch.runtime.serve --socket S --shutdown
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional

DEFAULT_SOCKET = os.path.join(tempfile.gettempdir(), "recon3d_tpu_torch.sock")
DEFAULT_READ_TIMEOUT_S = 10.0
# A client that reads none of its replies for this long is taken as gone.
SEND_TIMEOUT_S = 60.0
MAX_REQUEST_BYTES = 1 << 20
_PKG_ROOT = Path(__file__).resolve().parents[2]


class _LineForwarder(io.TextIOBase):
    """File-like stdout replacement that forwards complete lines."""

    def __init__(self, emit: Callable[[str], None]):
        self._emit = emit
        self._buf = ""

    def write(self, s: str) -> int:
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self._emit(line)
        return len(s)

    def flush(self) -> None:
        if self._buf:
            self._emit(self._buf)
            self._buf = ""


def _send(conn: socket.socket, obj: dict) -> None:
    conn.sendall((json.dumps(obj) + "\n").encode())


class _Client:
    """One accepted connection. `send` never raises: the first failed
    write (peer closed, reset, or not reading for SEND_TIMEOUT_S) marks
    the client gone, and later replies are dropped."""

    def __init__(self, conn: socket.socket):
        self.conn = conn
        self.gone = False

    def send(self, obj: dict) -> bool:
        if self.gone:
            return False
        try:
            _send(self.conn, obj)
            return True
        except OSError:
            self.gone = True
            return False


def _read_line(conn: socket.socket, timeout: float) -> str:
    """The first line a connection sends, within `timeout` seconds in all
    (a client that sends slowly gets no more time than a silent one).
    Raises TimeoutError; returns '' when the client closes first."""
    deadline = time.monotonic() + timeout
    buf = b""
    while b"\n" not in buf:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError
        conn.settimeout(left)
        chunk = conn.recv(65536)
        if not chunk:
            break
        buf += chunk
        if len(buf) > MAX_REQUEST_BYTES:
            raise ValueError("request line too long")
    return buf.split(b"\n", 1)[0].decode(errors="replace")


class ReconstructionServer:
    """Single-worker reconstruction daemon over a Unix domain socket.

    device: where requests without --device run ("cuda" unless asked);
    resolved when the server is made, so a daemon asked for a GPU it does
    not have raises before it binds. read_timeout: seconds a connection
    has to send its request line."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET, quiet: bool = False,
                 device: str = "cuda", read_timeout: float = DEFAULT_READ_TIMEOUT_S):
        from recon3d_tpu_torch.runtime.device import resolve_device

        self.device = resolve_device(device)
        self.socket_path = socket_path
        self.quiet = quiet
        self.read_timeout = read_timeout
        self._sock: Optional[socket.socket] = None
        self.requests_served = 0
        self.dropped = 0

    # -- lifecycle ----------------------------------------------------------

    def bind(self) -> None:
        state = probe(self.socket_path, timeout=2.0)
        if state != "dead":
            raise RuntimeError(
                f"another server is live on {self.socket_path} ({state})"
            )
        path = Path(self.socket_path)
        # connect() was refused: a daemon died without unlinking its path
        with contextlib.suppress(FileNotFoundError):
            path.unlink()
        path.parent.mkdir(parents=True, exist_ok=True)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(16)

    def warm(self) -> None:
        """Create the device context, load K1 and the pipeline's modules,
        and make this thread's cuBLAS and cuSOLVER handles, so the first
        request pays for none of them."""
        import torch

        from recon3d_tpu_torch.runtime.warmup import warm_device_async

        done = warm_device_async(self.device)
        import recon3d_tpu_torch.cli  # noqa: F401
        import recon3d_tpu_torch.sfm.pipeline  # noqa: F401

        # PyTorch makes these handles per thread: make the serving thread's
        a = 2.0 * torch.eye(8, device=self.device)
        float(torch.linalg.solve(a @ a, torch.ones(8, device=self.device)).sum())
        done.wait()

    def serve_forever(self) -> None:
        if self._sock is None:
            self.bind()
        try:
            self.warm()
            self._log(f"[serve] listening on {self.socket_path} ({self.device})")
            while True:
                conn, _ = self._sock.accept()
                with conn:
                    try:
                        if not self._handle(conn):
                            break
                    except Exception as e:  # noqa: BLE001 — daemon must survive clients
                        self._log(f"[serve] connection failed: {type(e).__name__}: {e}")
        finally:
            self.close()

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
            with contextlib.suppress(OSError):
                os.unlink(self.socket_path)

    def _log(self, line: str) -> None:
        if not self.quiet:
            print(line, flush=True)

    # -- request handling ---------------------------------------------------

    def _handle(self, conn: socket.socket) -> bool:
        """Serve one connection. Returns False when asked to shut down."""
        try:
            line = _read_line(conn, self.read_timeout)
        except TimeoutError:
            self.dropped += 1
            self._log(f"[serve] dropped a connection that sent no request in "
                      f"{self.read_timeout:g} s")
            return True
        except (OSError, ValueError):
            return True
        conn.settimeout(SEND_TIMEOUT_S)
        client = _Client(conn)
        if not line.strip():
            return True
        try:
            req = json.loads(line)
        except json.JSONDecodeError:
            req = None
        if not isinstance(req, dict):
            client.send({"done": True, "exit_code": 2, "error": "bad request JSON"})
            return True
        if req.get("ping"):
            client.send({"pong": True, "requests_served": self.requests_served,
                         "dropped": self.dropped, "device": str(self.device)})
            return True
        if req.get("shutdown"):
            client.send({"done": True, "exit_code": 0})
            self._log("[serve] shutdown requested")
            return False
        argv = req.get("argv")
        if not isinstance(argv, list):
            client.send({"done": True, "exit_code": 2,
                         "error": "request needs 'argv' (list of CLI args)"})
            return True
        rc = self._run(client, [str(a) for a in argv])
        self.requests_served += 1
        client.send({"done": True, "exit_code": rc})
        return True

    def _run(self, client: _Client, argv: List[str]) -> int:
        from recon3d_tpu_torch import cli

        if not any(a == "--device" or a.startswith("--device=") for a in argv):
            argv = argv + ["--device", self.device.type]
        real_stdout = sys.stdout

        def emit(line: str) -> None:
            if not self.quiet:
                print(line, file=real_stdout, flush=True)
            client.send({"log": line})  # a vanished client: finish the job regardless

        fwd = _LineForwarder(emit)
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(fwd):
                rc = cli.main(argv)
        except SystemExit as e:  # argparse and resolve_dataset errors
            fwd.flush()
            if e.code is not None and not isinstance(e.code, int):
                emit(str(e.code))
            rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
        except Exception as e:  # noqa: BLE001 — daemon must survive requests
            import traceback

            fwd.flush()
            emit(f"ERROR: {type(e).__name__}: {e}")
            for tb_line in traceback.format_exc().splitlines():
                emit(tb_line)
            rc = 1
        fwd.flush()
        emit(f"[serve] request finished in {time.time() - t0:.1f}s "
             f"(exit {rc})")
        return rc if isinstance(rc, int) else 0


# -- client: the socket and JSON only ---------------------------------------


def probe(socket_path: str = DEFAULT_SOCKET, timeout: float = 2.0) -> str:
    """What holds socket_path: "live" (a server answered a ping), "busy" (a
    server accepted the connection but did not answer within timeout: it
    is serving a request) or "dead" (the path is missing or connect() was
    refused: no server, possibly a stale file)."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        try:
            s.connect(socket_path)
        except (FileNotFoundError, ConnectionRefusedError):
            return "dead"
        except OSError:  # a full backlog, no permission: someone holds it
            return "busy"
        try:
            _send(s, {"ping": True})
            reply = s.makefile("r").readline()
            return "live" if json.loads(reply).get("pong") else "busy"
        except (OSError, ValueError, AttributeError):
            return "busy"


def ping(socket_path: str = DEFAULT_SOCKET, timeout: float = 5.0) -> bool:
    """True if a live server answers on socket_path."""
    return probe(socket_path, timeout) == "live"


def request(
    argv: List[str],
    socket_path: str = DEFAULT_SOCKET,
    on_log: Optional[Callable[[str], None]] = None,
) -> int:
    """Submit one CLI job to a running server; stream its stdout lines to
    on_log. Returns the job's exit code. Raises ConnectionError if no
    server is listening."""
    try:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(socket_path)
    except OSError as e:
        raise ConnectionError(
            f"no reconstruction server on {socket_path}: {e}"
        ) from e
    with s:
        _send(s, {"argv": argv})
        for line in s.makefile("r"):
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "log" in msg and on_log is not None:
                on_log(msg["log"])
            if msg.get("done"):
                return int(msg.get("exit_code", 1))
    return 1  # connection closed without a terminal message


def shutdown(socket_path: str = DEFAULT_SOCKET) -> bool:
    """Ask a running server to exit. True if it acknowledged."""
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(socket_path)
            _send(s, {"shutdown": True})
            reply = s.makefile("r").readline()
        return bool(json.loads(reply).get("done"))
    except (OSError, json.JSONDecodeError, ValueError):
        return False


def ensure_server(
    socket_path: str = DEFAULT_SOCKET,
    spawn_timeout: float = 120.0,
    device: str = "cuda",
) -> bool:
    """Make sure a server holds socket_path, spawning a detached daemon on
    `device` only when the path is dead. True once a server answers a
    ping, or at once for a busy one (it takes the next request from its
    backlog); False if the spawned daemon exits or does not answer in
    time."""
    if probe(socket_path, timeout=2.0) != "dead":
        return True
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_PKG_ROOT), env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "recon3d_tpu_torch.runtime.serve",
         "--socket", socket_path, "--quiet", "--device", device],
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        start_new_session=True,
        env=env,
    )
    deadline = time.time() + spawn_timeout
    while time.time() < deadline:
        if ping(socket_path, timeout=2.0):
            return True
        if proc.poll() is not None:
            return False
        time.sleep(0.25)
    return False


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="recon3d_tpu_torch.serve",
        description="Persistent reconstruction service (device, kernels and "
                    "modules kept loaded across requests)",
    )
    p.add_argument("--socket", default=DEFAULT_SOCKET,
                   help=f"Unix socket path (default {DEFAULT_SOCKET})")
    p.add_argument("--submit", nargs=argparse.REMAINDER, default=None,
                   metavar="CLI_ARGS",
                   help="Submit a CLI job to a running server instead of "
                        "starting one; everything after --submit is the "
                        "recon3d_tpu_torch.cli argv")
    p.add_argument("--shutdown", action="store_true",
                   help="Stop a running server")
    p.add_argument("--ensure", action="store_true",
                   help="With --submit: auto-start the server if none is "
                        "running")
    p.add_argument("--quiet", action="store_true",
                   help="Server: don't mirror request logs to stdout")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Server: where requests without --device run "
                        "(default cuda)")
    p.add_argument("--read-timeout", type=float, default=DEFAULT_READ_TIMEOUT_S,
                   help="Server: seconds a connection has to send its request "
                        f"(default {DEFAULT_READ_TIMEOUT_S:g})")
    args = p.parse_args(argv)

    if args.shutdown:
        ok = shutdown(args.socket)
        print("server stopped" if ok else "no server running")
        return 0 if ok else 1
    if args.submit is not None:
        if not args.submit:
            p.error("--submit needs CLI arguments")
        if args.ensure and not ensure_server(args.socket, device=args.device):
            print("ERROR: could not start server", file=sys.stderr)
            return 1
        try:
            return request(args.submit, args.socket, on_log=print)
        except ConnectionError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
    try:
        server = ReconstructionServer(args.socket, quiet=args.quiet, device=args.device,
                                      read_timeout=args.read_timeout)
        server.bind()
    except RuntimeError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
