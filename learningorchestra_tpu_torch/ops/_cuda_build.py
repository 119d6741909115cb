"""Shared plumbing of the hand-written CUDA kernels.

Each kernel module owns one source under ``csrc/`` with a plain C
interface. ``CudaLibrary`` compiles it with ``nvcc`` for ``sm_90a`` at
first use, into a content-addressed shared library under the
git-ignored ``build/<name>/`` (an edited source never loads a stale
build), and loads it with ctypes. Sources build independently, one
``nvcc`` each, so several can build at once.

The launch-side helpers are shared too: the device check that sends CPU
tensors to a kernel's plain version and refuses anything but CUDA or
CPU, the input contract check, the CUDA error check after a launch, and
a thread-safe count of launches per wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from learningorchestra_tpu_torch.utils import resources

_PKG = Path(__file__).resolve().parent.parent
#: Build products live beside the package, in a directory git ignores.
BUILD_ROOT = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); nvcc "
                           "is needed to build the CUDA kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class CudaLibrary:
    """``csrc/<name>.cu`` built into ``build/<name>/`` and loaded once.

    ``signatures`` maps each C entry point to its ctypes argument types;
    every entry point returns an ``int`` CUDA error code."""

    def __init__(self, name: str, signatures: Dict[str, List]):
        self.name = name
        self.source = _PKG / "csrc" / f"{name}.cu"
        self.build_dir = BUILD_ROOT / name
        self._signatures = signatures
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        #: Whether this process already accounted for the library (built
        #: it, or found it built by an earlier process).
        self._accounted = False

    def path(self) -> Path:
        """The shared library for the current source and flags."""
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return self.build_dir / f"lib{self.name}-{digest[:16]}.so"

    def log_path(self) -> Path:
        """nvcc's output for the current library (ptxas's registers,
        shared memory and spills per kernel)."""
        return self.path().with_suffix(".log")

    def build(self) -> Path:
        """Compile the source if it has no library yet (nvcc's output
        kept at ``log_path()``); returns the library's path."""
        so = self.path()
        if so.exists():
            if not self._accounted:
                self._accounted = True
                resources.note_persistent_hit()
            return so
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.monotonic()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        # A build is one of the package's compiles (utils/resources.py),
        # failed or not: its seconds were spent.
        resources.note_compile(time.monotonic() - t0)
        self._accounted = True
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        log = Path(f"{tmp}.log")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(log, self.log_path())
        os.replace(tmp, so)
        return so

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if needed (once per process)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for fn_name, args in self._signatures.items():
                    fn = getattr(lib, fn_name)
                    fn.argtypes = args
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


class LaunchCounter:
    """Kernel launches per wrapper; a wrapper adds one where it launches
    its kernel, and nowhere else."""

    def __init__(self, names: Iterable[str]):
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {k: 0 for k in names}

    def add(self, name: str) -> None:
        with self._lock:
            self._counts[name] += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            for k in self._counts:
                self._counts[k] = 0


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA inputs, False for CPU ones; anything else — mixed
    devices or another device type — is refused."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(
            f"inputs on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"kernels run on cuda or cpu, not {dev.type}")


def need(t: torch.Tensor, name: str, dtype: torch.dtype,
         shape: Tuple[int, ...]) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")
