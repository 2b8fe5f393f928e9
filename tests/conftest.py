"""Test configuration: CPU backend with 8 virtual devices (the standard way
to test pjit/collectives without a pod) and float64 for numerical parity
with the reference's numpy implementation."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# persistent compile cache: the jitted CP loop is expensive to build on the
# small CI CPU; cache it across test runs. ALSO a crash mitigation: this
# jax 0.9 build's XLA:CPU flakily segfaults/aborts after ~150+ REAL
# compilations in one process (reproduced across unrelated tests, plain
# and shard_map programs alike, never early in a process) — a warm cache
# keeps the per-process compile count low. On a COLD cache, warm it first
# in chunks (e.g. `pytest tests/test_a*.py` ... in separate invocations)
# instead of one full-suite process.
jax.config.update("jax_compilation_cache_dir", "/tmp/jax_test_cache")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


# Run the multi-device (shard_map / GSPMD) modules FIRST: their compiles
# are the biggest, so on a cold cache they land in the fresh-process
# window where XLA:CPU is reliable; with a warm cache the order is
# irrelevant. The stable sort keeps intra-module order.
_MULTI_DEVICE_FIRST = ("tests.test_subtree", "tests.test_sharding",
                       "tests.test_stacked", "tests.test_mpc",
                       "tests.test_distributed")


def pytest_collection_modifyitems(session, config, items):
    def rank(item):
        name = getattr(item.module, "__name__", "")
        for i, mod in enumerate(_MULTI_DEVICE_FIRST):
            if name == mod or name.endswith(mod.split(".")[-1]):
                return (0, i)
        return (1, 0)

    items.sort(key=rank)


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound the number of executables LIVE in the process: this jax 0.9
    build's XLA:CPU crashes (segfault/abort — in compile, cache write, or
    cache read/load alike) once a long-lived process accumulates roughly
    150+ loaded programs; the round-4 suite crosses that in one
    `pytest tests/` process. Dropping the in-process caches after every
    module keeps the live set at the per-module peak; re-loads hit the
    warm persistent cache."""
    yield
    jax.clear_caches()
