"""Process-isolated reconstruction worker (PyTorch port of
recon3d_tpu/runtime/worker.py).

Runs a reconstruction as a subprocess of the CLI, streams its stdout to a
log callback, sniffs progress keywords into coarse step statuses, and
reports success by exit code. Plain subprocess + callables, so it works
headless; the Qt GUI layer (gui/app.py) wraps it with signals when Qt is
present.
"""

from __future__ import annotations

import subprocess
import sys
import threading
from typing import Callable, Dict, List, Optional

StatusCb = Callable[[str], None]
LogCb = Callable[[str], None]
DoneCb = Callable[[bool], None]

CLI_MODULE = "recon3d_tpu_torch.cli"
COLMAP_MODULE = "recon3d_tpu_torch.tools.run_colmap"


def build_command(dataset: str, options: Dict) -> List[str]:
    """options dict -> argv.

    method: 'colmap_dense' | 'colmap_sparse' | anything else = custom
    pipeline with neural/mvs/stereo/dense/fast + max_images/output keys.
    `device` ('cuda' or 'cpu') becomes the CLI's --device.
    """
    cmd = [sys.executable, "-m"]
    method = options.get("method", "custom")

    if method in ("colmap_dense", "colmap_sparse"):
        args = [COLMAP_MODULE, dataset,
                "--quality", options.get("quality", "medium")]
        if method == "colmap_sparse":
            args.append("--sparse-only")
        if not options.get("use_gpu", True):
            args.append("--no-gpu")
    else:
        args = [CLI_MODULE, dataset]
        if options.get("neural"):
            args.append("--neural")
        if options.get("combined"):
            args.append("--combined")
        elif options.get("mvs"):
            args.append("--mvs")
        elif options.get("stereo"):
            args.append("--stereo")
        elif options.get("dense"):
            args.append("--dense")
        elif not options.get("global_sfm"):
            args.append("--fast")
        if options.get("mesh"):
            args.append("--mesh")
        if options.get("global_sfm"):
            args.append("--global-sfm")
        if options.get("max_images") is not None:
            args.extend(["--max-images", str(options["max_images"])])
        if options.get("output"):
            args.extend(["--output", str(options["output"])])
        if options.get("devices") is not None:
            args.extend(["--devices", str(options["devices"])])
        if options.get("device"):
            args.extend(["--device", str(options["device"])])
    return cmd + args


def sniff_status(line: str) -> Optional[str]:
    """Map a stdout line to a coarse progress status."""
    low = line.lower()
    if "extracting features" in low or "[sfm] features" in low:
        return "Step 1/4: Extracting Features..."
    if "matching" in low:
        return "Step 2/4: Matching Features..."
    if "registered image" in low or ("sparse" in low and "recon" in low):
        return "Step 3/4: Sparse Reconstruction..."
    if "dense" in low or "stereo" in low or "patchmatch" in low:
        return "Step 4/4: Dense Reconstruction..."
    if "saved" in low and ".ply" in low:
        return "Saving results..."
    return None


def status_step(status: Optional[str]) -> Optional[int]:
    """Progress-bar position (1-4) for a sniff_status string, or None;
    "Saving results..." maps to the final step."""
    if not status:
        return None
    if status.startswith("Step "):
        return int(status[5])
    if status.startswith("Saving"):
        return 4
    return None


class ReconstructionWorker:
    """Spawn the CLI as a subprocess and stream its progress.

    run(dataset, options) blocks until done (call from a thread for async
    use — start_async does that). Callbacks: on_log(line), on_status(text),
    on_finished(success).
    """

    def __init__(
        self,
        on_log: Optional[LogCb] = None,
        on_status: Optional[StatusCb] = None,
        on_finished: Optional[DoneCb] = None,
    ):
        self.on_log = on_log or (lambda s: None)
        self.on_status = on_status or (lambda s: None)
        self.on_finished = on_finished or (lambda ok: None)
        self.process: Optional[subprocess.Popen] = None
        self._thread: Optional[threading.Thread] = None
        self.returncode: Optional[int] = None

    def run(self, dataset: str, options: Optional[Dict] = None) -> bool:
        options = options or {}
        if options.get("serve_socket"):
            return self._run_via_server(dataset, options)
        cmd = build_command(dataset, options)
        self.on_log(f"Executing: {' '.join(cmd)}")
        self.process = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            bufsize=1,
        )
        last_status = None
        assert self.process.stdout is not None
        for raw in self.process.stdout:
            line = raw.rstrip()
            if not line:
                continue
            self.on_log(line)
            status = sniff_status(line)
            if status and status != last_status:
                last_status = status
                self.on_status(status)
        self.returncode = self.process.wait()
        ok = self.returncode == 0
        self.on_finished(ok)
        return ok

    def _run_via_server(self, dataset: str, options: Dict) -> bool:
        """Route the job through a persistent reconstruction service
        (runtime/serve.py) instead of a fresh subprocess, so that it runs in
        a process whose device, kernels and modules are already loaded. The
        argv is the one build_command would exec; COLMAP methods always run
        as subprocesses (an external binary: nothing to keep warm)."""
        cmd = build_command(dataset, options)
        if cmd[2] != CLI_MODULE:  # cmd = [python, -m, module, ...]
            return self.run(dataset, {**options, "serve_socket": None})
        argv = cmd[3:]
        from recon3d_tpu_torch.runtime import serve

        sock = options["serve_socket"]
        if options.get("serve_autostart", True):
            serve.ensure_server(sock, device=options.get("device") or "cuda")
        self.on_log(f"Submitting to reconstruction service at {sock}: "
                    f"{' '.join(argv)}")
        last_status = None

        def on_log(line: str) -> None:
            self.on_log(line)
            nonlocal last_status
            status = sniff_status(line)
            if status and status != last_status:
                last_status = status
                self.on_status(status)

        try:
            self.returncode = serve.request(argv, sock, on_log=on_log)
        except ConnectionError as e:
            self.on_log(f"ERROR: {e}")
            self.returncode = 1
        ok = self.returncode == 0
        self.on_finished(ok)
        return ok

    def start_async(self, dataset: str, options: Optional[Dict] = None):
        """Run in a daemon thread."""
        self._thread = threading.Thread(
            target=self.run, args=(dataset, options), daemon=True
        )
        self._thread.start()
        return self._thread

    def stop(self):
        if self.process and self.process.poll() is None:
            self.process.terminate()
