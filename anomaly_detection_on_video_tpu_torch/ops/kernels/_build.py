"""Build and load the CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into an object
file, all sources in parallel, and the objects link into one shared library
with a plain C interface, loaded with ``ctypes``. The build runs at first
use, into ``build/kernels/`` beside the package (listed in ``.gitignore``)
or the directory given to ``set_build_dir`` (``--compile-cache``), under a
name that hashes the sources and the nvcc flags, so an edited kernel or a
changed flag never loads a stale library. Concurrent builds into one
directory write their objects and library under their own process id and
rename the library into place. Nothing here runs at import time: this
module is imported on hosts without a CUDA toolkit, where only the plain
versions run.
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


def set_build_dir(path) -> None:
    """Build into and load from ``path`` (created if missing) instead of
    ``build/kernels/``. The library loads once per process, so once it has
    loaded, asking for another directory raises: call this before the
    first kernel launch."""
    global BUILD_DIR
    path = Path(path).resolve()
    with _LOCK:
        if _LIB is not None and path != BUILD_DIR.resolve():
            raise RuntimeError(f"the kernel library already loaded from {_LIB.path}; set the "
                               "build directory before the first kernel launch")
        path.mkdir(parents=True, exist_ok=True)
        BUILD_DIR = path


def library_path() -> Path:
    """Where ``build`` puts the library of the current sources and flags:
    ``BUILD_DIR/<tag>/libadv_kernels.so``, the tag hashing every
    ``csrc/`` file's name and bytes, ``ARCH_FLAGS`` and ``NVCC_FLAGS``
    (not the toolkit's version)."""
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update("\0".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / digest.hexdigest()[:16] / "libadv_kernels.so"


def build() -> KernelLibrary:
    """Compile (when no library of these sources and flags is there) and
    load the kernel library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib_path = library_path()
        out_dir = lib_path.parent
        log_path = out_dir / "build.log"
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            pid = os.getpid()
            objects, procs = [], []
            for src in sorted(CSRC_DIR.glob("*.cu")):
                obj = out_dir / f"{src.stem}.{pid}.o"
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
            tmp = out_dir / f"libadv_kernels.{pid}.so"
            link = subprocess.run(
                [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
            tmp_log = out_dir / f"build.{pid}.log"
            tmp_log.write_text("\n".join(logs))
            os.replace(tmp_log, log_path)
            os.replace(tmp, lib_path)
            for obj in objects:
                obj.unlink()
        log = log_path.read_text() if log_path.exists() else ""
        _LIB = KernelLibrary(lib_path, log)
        return _LIB
