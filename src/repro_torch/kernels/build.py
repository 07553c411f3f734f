"""Build and load the port's CUDA kernels: nvcc by hand into a shared
library with a plain C interface, loaded with ``ctypes``.

Each kernel source ``csrc/<name>.cu`` becomes
``build/kernels/<name>_<hash>.so``, the hash taken over the source, every
header it includes with ``#include "..."`` and the nvcc flags, so a changed
source, header or flag rebuilds and an unchanged one is reused.  Nothing is
built at import: a `KernelLibrary` compiles at its first `load` (or when a
caller starts the build early with `start_build`, as ``chip_smoke.py`` does
to run every nvcc at once).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
# --fmad=false and IEEE division: the kernels' arithmetic then rounds as
# the plain PyTorch versions' separate ops do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-prec-div=true", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    """``build/kernels`` at the checkout's root (``REPRO_TORCH_BUILD_DIR``
    overrides)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_includes(source: Path) -> list[Path]:
    """Every file a source reaches through ``#include "..."`` (resolved
    beside the including file, as nvcc does), transitively, in first-seen
    order: the headers a build depends on."""
    found: list[Path] = []
    todo = [source]
    while todo:
        including = todo.pop(0)
        for name in _INCLUDE.findall(including.read_text()):
            path = (including.parent / name).resolve()
            if path.exists() and path not in found:
                found.append(path)
                todo.append(path)
    return found


class KernelLibrary:
    """One kernel source, its build and its loaded library.

    ``bind`` sets the ``argtypes``/``restype`` of the library's C entry
    points once it is loaded (ctypes would otherwise pass pointers as
    32-bit ints).
    """

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None],
                 flags: tuple[str, ...] = NVCC_FLAGS):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.flags = flags
        self.bind = bind
        self.build_log = ""        # nvcc's output (-Xptxas -v), last build
        self._lib: Optional[ctypes.CDLL] = None

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in local_includes(self.source):
            h.update(header.name.encode())
            h.update(header.read_bytes())
        h.update(" ".join(self.flags).encode())
        return build_dir() / f"{self.name}_{h.hexdigest()[:16]}.so"

    def start_build(self) -> subprocess.Popen | None:
        """Start nvcc unless the library exists; returns the process (None
        when there is nothing to build).  nvcc writes a temporary file that
        `finish_build` renames into place."""
        out = self.library_path()
        if out.exists():
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc_path(), *self.flags, "-o", tmp, str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        proc.tmp_path = tmp
        return proc

    def finish_build(self, proc: subprocess.Popen | None) -> None:
        """Wait for `start_build`'s nvcc; raise with its output if it
        failed."""
        if proc is None:
            return
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            os.unlink(proc.tmp_path)
            raise RuntimeError(f"nvcc failed building {self.source}:\n{log}")
        os.replace(proc.tmp_path, self.library_path())

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library_path()))
            self.bind(lib)
            self._lib = lib
        return self._lib


def check_launch(name: str, rc: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
