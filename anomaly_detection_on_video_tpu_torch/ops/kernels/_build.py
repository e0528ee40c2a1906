"""Build and load the CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into an object
file, all sources in parallel, and the objects link into one shared library
with a plain C interface, loaded with ``ctypes``. The build runs at first
use, into ``build/kernels/`` beside the package (listed in ``.gitignore``),
under a name that hashes the sources, so an edited kernel never loads a
stale library. Nothing here runs at import time: this module is imported on
hosts without a CUDA toolkit, where only the plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "--resource-usage"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    "adv_crop_norm": [_P, _P, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I), _F, _F, _P],
    "adv_stem": [_P, _P, _P, _P, _P, _I, _I, _P],
    "adv_stem_info": [ctypes.POINTER(_I)],
    "adv_bottleneck": [_P] * 14 + [_I, _I, _I, _I, _I, _P],
    "adv_int8_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "adv_int8_conv": [_P, _P, _P, _P] + [_I] * 16 + [_P],
}


class KernelLibrary:
    """The loaded shared library plus what its build printed."""

    def __init__(self, path: Path, log: str):
        self.path = path
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        """Call an entry point; raise if the launch reported a CUDA error."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")


def current_stream(tensor: torch.Tensor) -> int:
    """The handle of the current CUDA stream on ``tensor``'s device, which
    a kernel launches on: ``torch.cuda.current_stream(device).cuda_stream``
    without building a Stream object on every launch."""
    return torch._C._cuda_getCurrentRawStream(tensor.get_device())


_LIB: Optional[KernelLibrary] = None
_LOCK = threading.Lock()


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def build() -> KernelLibrary:
    """Compile (when the sources changed) and load the kernel library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        digest = hashlib.sha256()
        for src in _sources():
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        tag = digest.hexdigest()[:16]
        out_dir = BUILD_DIR / tag
        lib_path = out_dir / "libadv_kernels.so"
        log_path = out_dir / "build.log"
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            objects, procs = [], []
            for src in sorted(CSRC_DIR.glob("*.cu")):
                obj = out_dir / (src.stem + ".o")
                cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                procs.append((src, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
                objects.append(obj)
            logs, failed = [], []
            for src, proc in procs:
                output, _ = proc.communicate()
                logs.append(f"== {src.name} (rc {proc.returncode})\n{output}")
                if proc.returncode != 0:
                    failed.append(src.name)
            if failed:
                raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
            tmp = out_dir / f"libadv_kernels.{os.getpid()}.so"
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
            os.replace(tmp, lib_path)
            log_path.write_text("\n".join(logs))
        log = log_path.read_text() if log_path.exists() else ""
        _LIB = KernelLibrary(lib_path, log)
        return _LIB
