"""Fixtures the port's test modules share. Not a test module.

``jax_compile_cache``: the JAX references of the port's tests build their
``jax.jit`` functions anew in every call (each ``run.py`` or ``infer.py``
run, each flax ``init`` and ``apply`` of a parametrized case), so one
program is compiled many times in a worker. With XLA's persistent
compilation cache on, pointed at one directory per worker, a program
compiled once is loaded from the cache after that: the same executable,
without the compile. A module imports the fixture to use it (it is
autouse); the worker's JAX settings come back after the module.
"""

import jax
import pytest
from jax.experimental.compilation_cache import compilation_cache

from anomaly_detection_on_video_tpu.utils.compile_cache import enable_compile_cache

_SETTINGS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")


@pytest.fixture(autouse=True, scope="module")
def jax_compile_cache(tmp_path_factory):
    previous = {name: getattr(jax.config, name) for name in _SETTINGS}
    enable_compile_cache(str(tmp_path_factory.getbasetemp() / "xla_cache"))
    compilation_cache.reset_cache()  # the cache is set up once per process otherwise
    yield
    for name, value in previous.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()
