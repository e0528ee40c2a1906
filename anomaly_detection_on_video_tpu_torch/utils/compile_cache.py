"""A persistent kernel build directory (counterpart of the JAX package's
``utils/compile_cache.py``), for serving restarts.

The port's one compile step is the nvcc build of ``csrc/``
(``ops/kernels/_build.py``), which every fresh checkout runs once before
its first kernel launch. Pointing it at a directory that outlives the
checkout lets a restarted ``infer --serve`` / ``--watch``, a repeated
extraction or a relaunched training run load the built library instead of
compiling again. A library is found by a key that hashes the sources and
nvcc's flags (``_build.library_path``), so a shared directory never serves
one built from other sources or flags; the key does not cover the CUDA
toolkit's version.

Exposed as ``--compile-cache DIR`` on ``infer`` / ``extract_features`` and
``trainer.compile_cache: DIR`` on ``run``.
"""

from __future__ import annotations

__all__ = ["enable_compile_cache"]


def enable_compile_cache(path: str) -> None:
    """Build the kernels into, and load them from, ``path`` (created if
    missing). Must run before the first kernel launch of the process: once
    the library has loaded from another directory, this raises."""
    from ..ops.kernels import _build

    _build.set_build_dir(path)
