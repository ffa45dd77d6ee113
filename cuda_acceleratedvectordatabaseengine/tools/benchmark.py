"""``vdb-benchmark`` — end-to-end throughput benchmark with the reference's
CSV schema (X6, ``bench/benchmark.cpp``): columns
vectors,dimension,nlist,nprobe,k,train_time,add_time,search_time,qps,latency_ms
(``bench/benchmark.cpp:181-196``), default workload 1M×128D / nlist 1024 /
nprobe 10 / k 10 / 10K queries (``bench/benchmark.cpp:28-36``).
"""

from __future__ import annotations

import argparse
import csv
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="vdb benchmark → CSV")
    p.add_argument("--vectors", type=int, default=1_000_000)
    p.add_argument("--dimension", type=int, default=128)
    p.add_argument("--nlist", type=int, default=1024)
    p.add_argument("--nprobe", type=int, default=10)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--queries", type=int, default=10_000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--csv", default="-", help="output file (default stdout)")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from cuda_acceleratedvectordatabaseengine import (
        IVFFlatConfig,
        IVFFlatIndex,
        SearchParams,
    )

    key = jax.random.PRNGKey(42)
    # On-device generation: host→device corpus upload measures nothing
    # about the engine.
    x = jax.random.normal(
        key, (args.vectors, args.dimension), jnp.bfloat16
    )
    x.block_until_ready()

    idx = IVFFlatIndex(IVFFlatConfig(
        dimension=args.dimension, nlist=args.nlist, dtype=args.dtype,
        train_sample_per_list=64,
    ))
    t0 = time.time()
    idx.train_from_device(x)
    jax.block_until_ready(idx.centroids)
    train_time = time.time() - t0

    t0 = time.time()
    idx.build_from_device(x)
    jax.block_until_ready(idx.arena.arena)
    add_time = time.time() - t0

    kq = jax.random.PRNGKey(7)
    queries = np.asarray(
        jax.random.normal(kq, (args.queries, args.dimension), jnp.float32)
    )
    params = SearchParams(nprobe=args.nprobe, k=args.k)
    # warm compile
    idx.search(queries[: args.batch], params)

    t0 = time.time()
    lat = []
    for start in range(0, args.queries, args.batch):
        t1 = time.time()
        idx.search(queries[start:start + args.batch], params)
        lat.append((time.time() - t1) * 1000)
    search_time = time.time() - t0
    qps = args.queries / search_time
    latency_ms = float(np.mean(lat))

    row = [
        args.vectors, args.dimension, args.nlist, args.nprobe, args.k,
        round(train_time, 3), round(add_time, 3), round(search_time, 3),
        round(qps, 1), round(latency_ms, 3),
    ]
    header = ["vectors", "dimension", "nlist", "nprobe", "k", "train_time",
              "add_time", "search_time", "qps", "latency_ms"]
    out = sys.stdout if args.csv == "-" else open(args.csv, "w")
    w = csv.writer(out)
    w.writerow(header)
    w.writerow(row)
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
