"""Recall@k evaluator — the missing ``vdb_recall_test`` (X7).

The reference plans this binary (``bench/CMakeLists.txt:29-44``) and has a
metrics hook waiting for it (``record_search_recall``,
``query_service.h:200-201``) but ships neither the file nor any recall
measurement. This CLI sweeps nprobe and reports recall@k against exact
brute-force ground truth, for IVF-Flat and IVF-PQ (±rerank).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def ground_truth(queries, x, k):
    """Exact top-k by blocked fp64-accurate numpy scan."""
    out = np.zeros((queries.shape[0], k), np.int64)
    q = queries.astype(np.float64)
    x_sq = (x.astype(np.float64) ** 2).sum(-1)
    for i in range(0, q.shape[0], 256):
        qb = q[i:i + 256]
        d = (qb ** 2).sum(-1)[:, None] - 2 * qb @ x.T.astype(np.float64) \
            + x_sq[None]
        out[i:i + 256] = np.argsort(d, axis=1, kind="stable")[:, :k]
    return out


def recall_at_k(found_ids, truth) -> float:
    hits = sum(
        len(set(f.tolist()) & set(t.tolist()))
        for f, t in zip(found_ids.astype(np.int64), truth)
    )
    return hits / truth.size


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="recall@k vs exact ground truth")
    p.add_argument("--vectors", type=int, default=100_000)
    p.add_argument("--dimension", type=int, default=128)
    p.add_argument("--nlist", type=int, default=256)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--queries", type=int, default=256)
    p.add_argument("--nprobe", type=int, nargs="+",
                   default=[1, 4, 8, 16, 32, 64])
    p.add_argument("--pq-m", type=int, default=0)
    p.add_argument("--clusters", type=int, default=0,
                   help="natural clusters in synthetic data "
                        "(0 = isotropic gaussian — IVF worst case)")
    p.add_argument("--noise", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    from cuda_acceleratedvectordatabaseengine import (
        IVFFlatConfig,
        IVFFlatIndex,
        IVFPQConfig,
        IVFPQIndex,
        SearchParams,
    )

    rng = np.random.default_rng(args.seed)
    if args.clusters:
        centers = rng.standard_normal((args.clusters, args.dimension))
        ci = rng.integers(0, args.clusters, args.vectors)
        x = (centers[ci] + args.noise * rng.standard_normal(
            (args.vectors, args.dimension))).astype(np.float32)
    else:
        x = rng.standard_normal(
            (args.vectors, args.dimension)
        ).astype(np.float32)
    qi = rng.integers(0, args.vectors, args.queries)
    queries = (x[qi] + 0.1 * rng.standard_normal(
        (args.queries, args.dimension))).astype(np.float32)

    print(f"[recall] ground truth over {args.vectors}×{args.dimension}...")
    truth = ground_truth(queries, x, args.k)

    if args.pq_m:
        index = IVFPQIndex(IVFPQConfig(
            dimension=args.dimension, nlist=args.nlist, m=args.pq_m,
        ))
    else:
        index = IVFFlatIndex(IVFFlatConfig(
            dimension=args.dimension, nlist=args.nlist,
        ))
    index.train(x)
    index.add(x)

    rows = []
    for nprobe in args.nprobe:
        for rerank in ([False, True] if args.pq_m else [False]):
            params = SearchParams(nprobe=nprobe, k=args.k,
                                  use_exact_rerank=rerank)
            index.search(queries[:8], params)  # warm compile
            t0 = time.time()
            _, ids = index.search(queries, params)
            dt = time.time() - t0
            r = recall_at_k(ids, truth)
            rows.append({
                "nprobe": nprobe,
                "rerank": rerank,
                f"recall@{args.k}": round(r, 4),
                "qps": round(args.queries / dt, 1),
            })
            print(f"  nprobe={nprobe:4d} rerank={int(rerank)} "
                  f"recall@{args.k}={r:.4f}  qps={args.queries / dt:.0f}")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
