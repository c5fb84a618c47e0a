"""Where the compile cache goes, and the chip smoke test's refusal to run
anywhere but on a GPU."""

import os
import sys
from types import SimpleNamespace

import pytest

import rptree_tpu
from rptree_tpu import _compile_cache_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_is_fixed_inside_the_checkout():
    assert rptree_tpu.CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize("environ,platforms,want", [
    ({}, "", "repo"),
    ({}, "cuda", "repo"),
    # JAX reads JAX_COMPILATION_CACHE_DIR itself: set no other directory
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, "", None),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, "cuda", None),
    ({"RPTREE_TPU_NO_CACHE": "1"}, "", None),
    # CPU executables are host-fingerprinted: no cache
    ({}, "cpu", None),
    ({}, "cuda,cpu", None),
])
def test_compile_cache_placement(environ, platforms, want):
    got = _compile_cache_dir(environ, platforms)
    assert got == (rptree_tpu.CACHE_DIR if want == "repo" else None)


def test_cpu_test_run_sets_no_cache():
    import jax

    assert jax.config.jax_compilation_cache_dir in (
        None, os.path.join(rptree_tpu.CACHE_DIR, "tests"))


def _smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


@pytest.mark.parametrize("platform", ["cpu", "other", None])
def test_chip_smoke_refuses_non_gpu(platform):
    smoke = _smoke()
    devs = [] if platform is None else [SimpleNamespace(platform=platform)]
    with pytest.raises(SystemExit) as e:
        smoke.require_gpu(devs)
    assert e.value.code != 0 and "GPU" in str(e.value.code)


def test_chip_smoke_accepts_gpu():
    smoke = _smoke()
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    assert smoke.require_gpu([dev]) is dev


def test_chip_smoke_exits_nonzero_on_cpu(capsys):
    """Run end to end on this CPU-only host: it stops at the device check
    and prints no result line."""
    smoke = _smoke()
    with pytest.raises(SystemExit) as e:
        smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_same_sets_up_to_ties():
    import numpy as np

    smoke = _smoke()
    d = np.array([[1.0, 2.0, 3.0]], np.float32)
    assert smoke.same_sets_up_to_ties(d, np.array([[1, 2, 3]]),
                                      d, np.array([[3, 2, 1]])) == 0
    # a swap among distances tied within the tolerance is accepted
    assert smoke.same_sets_up_to_ties(d, np.array([[1, 2, 3]]),
                                      d + 1e-6, np.array([[1, 2, 4]])) == 1
    with pytest.raises(AssertionError):
        smoke.same_sets_up_to_ties(d, np.array([[1, 2, 3]]),
                                   d + 0.5, np.array([[1, 2, 4]]))
