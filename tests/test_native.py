"""Native host runtime: build, and parity between C++ and NumPy paths."""

import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine import native


def test_native_builds_and_loads():
    assert native.available(), (
        "libvdbhost.so failed to build — g++/make expected in the image"
    )
    assert native._load().vdb_hardware_concurrency() >= 1


def test_gather_lists_matches_numpy(rng):
    lists = [
        rng.standard_normal((c, 8)).astype(np.float32)
        for c in (3, 0, 7, 5)
    ]
    out, sq = native.gather_lists(lists, cap=8, dim=8)
    assert out.shape == (4, 8, 8) and sq.shape == (4, 8)
    for i, arr in enumerate(lists):
        c = arr.shape[0]
        np.testing.assert_array_equal(out[i, :c], arr)
        np.testing.assert_array_equal(out[i, c:], 0)
        np.testing.assert_allclose(sq[i, :c], (arr ** 2).sum(-1),
                                   rtol=1e-5)
        np.testing.assert_array_equal(sq[i, c:], 0)


def test_gather_lists_truncates_overlong(rng):
    lists = [rng.standard_normal((10, 4)).astype(np.float32)]
    out, sq = native.gather_lists(lists, cap=6, dim=4)
    np.testing.assert_array_equal(out[0], lists[0][:6])


def test_gather_rows(rng):
    src = rng.standard_normal((100, 16)).astype(np.float32)
    rows = np.array([5, 0, 99, -1, 42], np.int64)
    out = native.gather_rows(src, rows)
    np.testing.assert_array_equal(out[0], src[5])
    np.testing.assert_array_equal(out[2], src[99])
    np.testing.assert_array_equal(out[3], 0)


def test_f32_to_bf16_matches_jax(rng):
    import jax.numpy as jnp

    x = rng.standard_normal(1000).astype(np.float32)
    got = native.f32_to_bf16(x)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(got, want)


def test_readahead(tmp_path):
    p = str(tmp_path / "blob")
    with open(p, "wb") as f:
        f.write(b"x" * 100_000)
    if native.available():
        assert native.readahead(p, 0, 100_000, touch_bytes=4096)
        assert not native.readahead(str(tmp_path / "missing"))
