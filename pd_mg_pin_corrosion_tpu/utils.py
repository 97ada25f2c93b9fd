"""Small host-side utilities (reference: src/utils.h Timer, :79-96)."""

from __future__ import annotations

import os
import time
from pathlib import Path


class Timer:
    """Wall-clock phase timer printing ``[Timer] label: X s`` on report().

    Mirrors the reference's Timer (src/utils.h:79-96); also usable as a
    context manager.
    """

    def __init__(self, label: str):
        self.label = label
        self.t0 = time.time()

    def report(self) -> float:
        dt = time.time() - self.t0
        print(f"  [Timer] {self.label}: {dt:.3f} s")
        return dt

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.report()
        return False


# persistent-compilation-cache directory used when JAX_COMPILATION_CACHE_DIR
# is unset: one fixed path inside the checkout (the path is part of the
# cache key, so a moving directory would never hit)
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def setup_compile_cache() -> str:
    """Enable JAX's persistent compilation cache; returns its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it by itself and this
    sets nothing. Otherwise the cache goes to CHECKOUT_CACHE_DIR. Call it
    before the first compilation: JAX fixes the cache when it first
    compiles.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
