"""Where JAX keeps its persistent compilation cache.

Every somvq process compiles the same winner and update programs; with
the persistent cache a later run reads them back instead of compiling
again.  If JAX_COMPILATION_CACHE_DIR is set, that directory is used and
no other is configured.  Otherwise the cache is `<checkout>/.jax_cache`
(listed in .gitignore): a fixed path, because the path is part of the
cache key, and inside the checkout, because the program writes nothing
outside it.
"""

from __future__ import annotations

import os
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory.

    Before `import jax` this only sets environment variables, so tools
    that never import jax keep their fast start."""
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))
    if "jax" in sys.modules:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    else:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = path
        os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1.0")
    return path
