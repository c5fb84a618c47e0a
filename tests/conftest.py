"""Test configuration: force a CPU backend with 8 virtual devices so the
multi-chip sharding paths can be exercised without accelerator hardware
(the standard JAX stand-in; see SURVEY.md section 4).

``RPTREE_GPU_TESTS=1`` leaves the platform to JAX instead, for running
the ``gpu``-marked tests on a card (``-m gpu``)."""

import os

_GPU_RUN = os.environ.get("RPTREE_GPU_TESTS") == "1"
if not _GPU_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"  # override any ambient platform
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
# The suite wall clock is XLA:CPU compiles of hundreds of tiny-shape
# programs; backend optimization buys nothing at test shapes.
if "xla_backend_optimization_level" not in flags:
    flags = (flags + " --xla_backend_optimization_level=0").strip()
os.environ["XLA_FLAGS"] = flags

import jax  # noqa: E402

# A platform plugin may already have pinned jax_platforms before this
# file ran; override through jax.config before any backend initialises.
if not _GPU_RUN:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

# Persistent compile cache: OPT-IN for dev loops (RPTREE_TEST_CACHE=1),
# kept in the checkout's own cache directory.  It cuts repeat suite runs
# severalfold, but it is off by default because the cache WRITE path
# segfaults this jaxlib on a handful of this suite's executables (jax
# 0.9.0 CPU, inside `executable.serialize()`), and a single-shot run
# gains nothing from it (jit already memoizes in-process).  A crashed run
# can corrupt the cache (symptom: INVALID_ARGUMENT at dispatch -- delete
# the directory).
if os.environ.get("RPTREE_TEST_CACHE") == "1":
    from rptree_tpu import CACHE_DIR  # noqa: E402

    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(CACHE_DIR, "tests"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_enable_xla_caches", "all")


# The long single-process suite accumulates hundreds of compiled
# executables; late in the run XLA:CPU compilation starts segfaulting
# (observed deterministically around the same test region on jax 0.9.0,
# in backend_compile_and_load -- and, with the persistent cache on, in
# executable.serialize()).  Isolated runs of the same tests pass, so the
# crash tracks accumulated in-process state, not any one program.
# Dropping the jit caches between MODULES bounds that accumulation; the
# cross-module recompiles it costs are small next to the suite's
# per-module compile load.
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    yield
    jax.clear_caches()


# Slow tier: tests marked @pytest.mark.rptree_slow run only under
# RPTREE_SLOW=1 (CI / pre-release).  Policy: ONLY tests whose coverage is
# substantially duplicated by a faster test or by the driver's own
# checks belong here -- no oracle-parity or sharded-equality assertion
# is exclusive to the slow tier.  Suite-wall arithmetic: the wall is
# XLA:CPU compiles of ~hundreds of distinct programs on ONE host core,
# and the per-module jax.clear_caches() above (load-bearing: accumulated
# executables segfault XLA:CPU late in the run, jax 0.9.0) forbids
# cross-module program reuse, so fixture session-scoping cannot buy
# compiles back -- only dropping distinct programs (or a multi-core
# host / fixed jaxlib) moves the total.
def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "rptree_slow: long-tail test; runs only with RPTREE_SLOW=1")
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; skips elsewhere (use the gpu_device fixture)")


@pytest.fixture
def gpu_device():
    """The first GPU device, for tests marked ``gpu``.  Whether a card is
    there is decided here, at run time -- never at import or collection,
    so every test worker collects the same tests.  The suite pins the
    CPU platform unless started with ``RPTREE_GPU_TESTS=1``."""
    if not _GPU_RUN:
        pytest.skip("needs a GPU: run with RPTREE_GPU_TESTS=1 on a GPU host")
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU: JAX found none")
    return gpus[0]


def pytest_collection_modifyitems(config, items):
    if os.environ.get("RPTREE_SLOW") == "1":
        return
    skip = pytest.mark.skip(reason="slow tier: set RPTREE_SLOW=1")
    for item in items:
        if "rptree_slow" in item.keywords:
            item.add_marker(skip)
