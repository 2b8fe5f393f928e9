"""Compilation helpers: the persistent compile cache and a compile clock.

The first compile of the jitted CP loop is the largest part of a cold run at
the benchmark widths, so every entry point (``bench.py``, ``chip_smoke.py``,
``scripts/*.py``) enables JAX's persistent compilation cache through
:func:`enable_compile_cache`. :func:`compile_clock` splits a wall-clock
measurement into the part JAX spent tracing, lowering and compiling and the
rest, so set-up and solve times are reported separately.
"""

import contextlib
import os

import jax

__all__ = ["compile_cache_dir", "enable_compile_cache", "compile_clock"]

_ENV = "JAX_COMPILATION_CACHE_DIR"
# the checkout root: raocp_tpu/utils/compilation.py -> three levels up
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the monitoring events JAX records around tracing, lowering and the backend
# compile (a persistent-cache hit is timed inside the last one)
_COMPILE_EVENTS = frozenset((
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
))


def compile_cache_dir() -> str:
    """The persistent cache directory: ``$JAX_COMPILATION_CACHE_DIR`` when
    set, else the fixed ``<checkout>/.jax_cache`` (the path is part of the
    cache key, so it must not move between runs)."""
    return os.environ.get(_ENV) or os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory. When
    ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself and the
    directory is left to JAX."""
    path = compile_cache_dir()
    if not os.environ.get(_ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


@contextlib.contextmanager
def compile_clock():
    """Measure the wall-clock seconds JAX spends compiling inside the block.

    Yields a zero-argument callable that returns the seconds so far: the
    length of the union of the trace / lower / compile spans (nested jits
    record nested spans, so the spans are merged, not summed)."""
    spans = []

    def listener(event, start, end, **_):
        if event in _COMPILE_EVENTS:
            spans.append((start, end))

    def seconds() -> float:
        total, reach = 0.0, float("-inf")
        for start, end in sorted(spans):
            if end > reach:
                total += end - max(start, reach)
                reach = end
        return total

    jax.monitoring.register_event_time_span_listener(listener)
    try:
        yield seconds
    finally:
        jax.monitoring.unregister_event_time_span_listener(listener)
