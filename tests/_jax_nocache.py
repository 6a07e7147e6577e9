"""JAX references computed with the persistent XLA:CPU compile cache off.

tests/conftest.py turns on a persistent compile cache that every test
worker shares.  Two references of the port's tests (JAX's camera rays in
test_torch_trace.py, JAX's render_aov depth in test_torch_raster.py)
each came out wrong once in a whole run and right in every rerun; an
executable read from that cache is the suspect.  Inside
`compile_cache_off()` JAX neither reads nor writes the persistent cache,
and the executables compiled earlier in the process are dropped first, so
the reference is compiled afresh here.
"""
import contextlib

import jax
from jax._src import compilation_cache


@contextlib.contextmanager
def compile_cache_off():
    # compilation_cache memoizes whether the cache is used at the first
    # compile of the process; reset_cache() makes it read the flag again
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    jax.clear_caches()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", True)
        compilation_cache.reset_cache()
