"""Build a source of the port into a shared library at first use.

The port's native code (the CUDA kernels under csrc/ and the host C++
point-cloud routines) is compiled on the machine that runs it, never when
a module is imported. Each library goes into recon3d_tpu_torch/_build
(git-ignored), named by a hash of its source and flags, so an unchanged
source is built once and an edited one anew. A build writes a temporary
file and renames it, so processes that build the same library at once
never load a half-written one.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def find_tool(name: str, *fallbacks: str) -> str:
    """The compiler `name` on PATH, else the first existing fallback path."""
    for cand in (shutil.which(name), *fallbacks):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found (PATH or {', '.join(fallbacks) or 'nowhere else'})")


def build_library(source: Path, stem: str, tool: str,
                  flags: Sequence[str]) -> Tuple[Path, float, str]:
    """Compile `source` with `tool flags -o LIB source` into
    BUILD_DIR/lib{stem}_{hash}.so unless that library exists. Returns
    (library path, seconds spent compiling, the compiler's log). Raises
    RuntimeError when the compiler fails."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{stem}_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return lib_path, 0.0, log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([tool, *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(tool)} failed on {source}:\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return lib_path, seconds, log
