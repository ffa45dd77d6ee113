"""The single scan choice per platform (ops/dispatch)."""

import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine import (
    IVFFlatConfig,
    IVFFlatIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine.ops.dispatch import (
    resolve_scan_impl,
)


@pytest.mark.parametrize(
    "impl, platform, want",
    [
        ("auto", "gpu", "grouped"),       # the kernel, at every shape
        ("auto", "cpu", "gather"),        # tests and tools
        ("gather", "gpu", "gather"),      # explicit wins
        ("gather", "cpu", "gather"),
        ("grouped", "cpu", "grouped"),
        ("grouped", "gpu", "grouped"),
    ],
)
def test_resolve_scan_impl(impl, platform, want):
    assert resolve_scan_impl(impl, platform) == want


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_resolve_scan_impl_refuses_other_platforms(platform):
    with pytest.raises(ValueError, match="no scan implementation"):
        resolve_scan_impl("auto", platform)


@pytest.mark.parametrize("impl", ["pallas", "pallas_sorted", "ragged"])
def test_resolve_scan_impl_rejects_removed_names(impl):
    with pytest.raises(ValueError, match="unknown scan_impl"):
        resolve_scan_impl(impl, "gpu")


def _index(rng, scan_impl, dtype="int8"):
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=32, nlist=8, dtype=dtype,
                                     scan_impl=scan_impl))
    idx.train(x)
    idx.add(x)
    return idx


def test_grouped_on_cpu_is_an_error_not_a_fallback(rng):
    """Asking for the kernel where it cannot run raises: nothing swaps in
    the interpreter or the reference behind the caller's back."""
    idx = _index(rng, "grouped")
    q = rng.standard_normal((3, 32)).astype(np.float32)
    with pytest.raises(Exception, match="(?i)interpret"):
        idx.search(q, SearchParams(nprobe=4, k=5))


@pytest.mark.parametrize(
    "dtype, k, nprobe",
    [("int8", 8, 4), ("bfloat16", 8, 4), ("float32", 8, 4), ("int8", 70, 1)],
)
def test_index_search_grouped_matches_gather(rng, dtype, k, nprobe,
                                             interpret_grouped):
    """Through the index's own entry point, the grouped kernel and the XLA
    reference scan return the same ids and distances for every arena
    dtype (bf16 compared against its exact stored values), and for a k
    deeper than one kernel pass."""
    idx = _index(rng, "grouped", dtype)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    params = SearchParams(nprobe=nprobe, k=k)
    d, ids = idx.search(q, params)
    if dtype == "bfloat16":
        import dataclasses

        import jax.numpy as jnp

        idx.arena = dataclasses.replace(
            idx.arena, arena=idx.arena.arena.astype(jnp.float32)
        )
    idx.config.scan_impl = "gather"
    d_ref, ids_ref = idx.search(q, params)
    np.testing.assert_array_equal(ids, ids_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)
