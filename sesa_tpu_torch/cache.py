"""Where the port keeps what it builds (counterpart of sesa_tpu/cache.py).

The JAX package caches XLA executables; the port's only build product is
its CUDA kernel libraries, which ``ops/_build.py`` keeps on disk under
this directory, keyed by a hash of their sources and flags, so every later
process loads them at once. The directory is ``$SESA_CACHE_DIR`` when set,
else ``sesa_tpu_torch/build`` beside the sources.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def cache_dir() -> str:
    return os.environ.get("SESA_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache() -> bool:
    """Make sure the cache directory exists. Returns True: the kernel
    libraries are always cached on disk, by source hash."""
    os.makedirs(cache_dir(), exist_ok=True)
    return True
