"""FlatIndex end-to-end tests (exactness vs oracle, growth, sentinels)."""

import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine import FlatIndex
from cuda_acceleratedvectordatabaseengine.models.arena import INVALID_ID


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_flat_exact(rng, oracle, metric):
    x = rng.standard_normal((500, 24)).astype(np.float32)
    q = rng.standard_normal((7, 24)).astype(np.float32)
    idx = FlatIndex(24, metric=metric, dtype=np.float32, chunk_size=128)
    idx.add(x)
    d, ids = idx.search(q, k=10)
    _, ref = oracle(q, x, 10, metric)
    assert np.array_equal(np.sort(ids), np.sort(ref.astype(np.uint64)))


def test_flat_remove_ids(rng, oracle):
    x = rng.standard_normal((600, 24)).astype(np.float32)
    idx = FlatIndex(24, dtype=np.float32, chunk_size=128)
    idx.add(x)
    victims = np.asarray([0, 5, 299, 598, 599], np.uint64)
    assert idx.remove_ids(victims) == len(victims)
    assert len(idx) == 595
    q = x[np.asarray(victims, np.int64)]
    d, ids = idx.search(q, k=10)
    assert not np.isin(ids, victims).any()
    # survivors exact vs oracle over the surviving rows
    keep = np.setdiff1d(np.arange(600), victims.astype(np.int64))
    q2 = rng.standard_normal((4, 24)).astype(np.float32)
    d2, ids2 = idx.search(q2, k=5)
    _, ref = oracle(q2, x[keep], 5)
    assert np.array_equal(np.sort(ids2),
                          np.sort(keep[ref].astype(np.uint64)))
    assert idx.remove_ids(victims) == 0


def test_flat_incremental_add_and_growth(rng, oracle):
    idx = FlatIndex(16, dtype=np.float32, chunk_size=256)
    chunks = [rng.standard_normal((700, 16)).astype(np.float32)
              for _ in range(3)]
    for i, c in enumerate(chunks):
        idx.add(c, ids=np.arange(i * 700, (i + 1) * 700, dtype=np.uint64))
    assert len(idx) == 2100
    q = rng.standard_normal((3, 16)).astype(np.float32)
    d, ids = idx.search(q, k=5)
    _, ref = oracle(q, np.concatenate(chunks), 5)
    assert np.array_equal(np.sort(ids), np.sort(ref.astype(np.uint64)))


def test_flat_underfull_returns_sentinels(rng):
    idx = FlatIndex(8, dtype=np.float32)
    idx.add(rng.standard_normal((3, 8)).astype(np.float32))
    d, ids = idx.search(rng.standard_normal((2, 8)).astype(np.float32), k=10)
    assert (ids[:, 3:] == INVALID_ID).all()
    assert (d[:, 3:] == np.finfo(np.float32).max).all()
    assert (ids[:, :3] != INVALID_ID).all()


def test_flat_custom_ids(rng):
    idx = FlatIndex(8, dtype=np.float32)
    x = rng.standard_normal((10, 8)).astype(np.float32)
    ids = (np.arange(10, dtype=np.uint64) + 1) * 1000
    idx.add(x, ids=ids)
    _, got = idx.search(x[:2], k=1)
    assert got[0, 0] == 1000 and got[1, 0] == 2000
