"""Build the port's hand-written CUDA C++ kernels and bind them with ctypes.

Each kernel is one ``.cu`` source under ``paddle_tpu_torch/csrc/`` (which
may include the shared ``.cuh`` headers there) with a plain ``extern "C"``
launcher that returns the launch's ``cudaError_t``. It is compiled with
``nvcc`` for ``sm_90a`` into its own shared library under
``paddle_tpu_torch/csrc/build/`` (git-ignored) at first use; the library's
file name carries a hash of the source, the headers and the flags, so an
edited source or header rebuilds and a stale library is never loaded.
Nothing is built or imported when this module is imported.

A :class:`CudaKernel` counts its launches in ``launches``: the count rises
by one exactly where the kernel is launched, so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# every kernel of the port, by name (chip_smoke.py builds and checks them all)
KERNELS: Dict[str, "CudaKernel"] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``/``$CUDA_PATH``, else ``PATH``, else the
    toolkit PyTorch found."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class CudaKernel:
    """One CUDA source, its ``extern "C"`` launcher and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()
        KERNELS[name] = self

    def library_path(self) -> Path:
        # the headers beside the sources count too: an edited shared
        # header rebuilds every kernel that may include it
        text = self.source.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}_{digest}.so"

    def start_build(self, extra_flags: Sequence[str] = ()) -> Optional["_Build"]:
        """Start ``nvcc`` on this kernel's source unless its library is
        already built; returns the running build (or None)."""
        lib = self.library_path()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a private output name, published with an atomic rename, so that
        # concurrent builders never load a half-written library
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return _Build(self, proc, tmp, lib)

    def fn(self):
        """The bound launcher, building the library first if needed."""
        if self._fn is None:
            with self._lock:
                if self._fn is None:
                    build = self.start_build()
                    if build is not None:
                        build.wait()
                    fn = getattr(ctypes.CDLL(str(self.library_path())), self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the launcher; raise if the launch was refused. Counts the
        launch."""
        rc = self.fn()(*args)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: cudaError {rc}")
        self.launches += 1


class _Build:
    def __init__(self, kernel: CudaKernel, proc: subprocess.Popen, tmp: Path, lib: Path):
        self.kernel, self.proc, self.tmp, self.lib = kernel, proc, tmp, lib
        self.started = time.perf_counter()

    def wait(self) -> str:
        """Wait for nvcc; publish the library; return nvcc's output."""
        out, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            self.tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {self.kernel.source.name} "
                f"(exit {self.proc.returncode}):\n{out}"
            )
        os.replace(self.tmp, self.lib)
        return out


def build_all(extra_flags: Sequence[str] = ()) -> Dict[str, dict]:
    """Build every registered kernel, one ``nvcc`` per source, all started
    together. Returns ``{name: {"seconds": s, "nvcc_output": text}}``
    (seconds 0 and no output for a library that was already built)."""
    builds = {}
    report = {}
    try:
        for name, k in KERNELS.items():
            builds[name] = k.start_build(extra_flags)
        for name, b in builds.items():
            if b is None:
                report[name] = {"seconds": 0.0, "nvcc_output": ""}
                continue
            out = b.wait()
            report[name] = {"seconds": time.perf_counter() - b.started, "nvcc_output": out}
    finally:  # a failed build leaves no nvcc running
        for b in builds.values():
            if b is not None and b.proc.poll() is None:
                b.proc.kill()
                b.proc.wait()
    return report
