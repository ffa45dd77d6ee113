"""``vdb-build-index`` — offline index builder CLI.

Implements the reference's ghost ``vdb_build_index`` binary (I12): reads an
Arrow IPC vectors file (or generates synthetic data), trains the coarse
quantizer (+ PQ codebooks), packs the index, and writes a snapshot — either
standalone or as a registered epoch ready for ``ActivateEpoch``.

Usage:
    vdb-build-index --source vectors.arrow --output /data/snap \\
        --dimension 768 --nlist 4096 [--pq-m 96] [--metric L2]
    vdb-build-index --synthetic 100000 --dimension 128 --output /tmp/snap
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Offline index builder")
    p.add_argument("--source", help="Arrow IPC vectors file")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic vectors instead of --source")
    p.add_argument("--output", required=True, help="snapshot directory")
    p.add_argument("--dimension", type=int, default=0,
                   help="(synthetic only; inferred from source otherwise)")
    p.add_argument("--nlist", type=int, default=1024)
    p.add_argument("--metric", default="L2")
    p.add_argument("--pq-m", type=int, default=0,
                   help="PQ subquantizers (0 = IVF-Flat)")
    p.add_argument("--pq-nbits", type=int, default=8)
    p.add_argument("--opq", action="store_true",
                   help="learn an OPQ rotation with the PQ codebooks "
                        "(ops/pq.opq_fit); persisted in the snapshot and "
                        "applied transparently at serve time")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--epoch-base", default="",
                   help="register the snapshot as an epoch under this "
                        "EpochManager base dir")
    p.add_argument("--index-name", default="default")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--chunk-rows", type=int, default=500_000,
                   help="rows streamed off --source per chunk (peak host "
                        "RAM ≈ one chunk; the arena is balanced with the "
                        "same capacity clamp the headline bench uses)")
    args = p.parse_args(argv)

    from cuda_acceleratedvectordatabaseengine import (
        IVFFlatConfig,
        IVFFlatIndex,
        IVFPQConfig,
        IVFPQIndex,
    )
    from cuda_acceleratedvectordatabaseengine.builder import (
        build_index_chunked,
        train_sample_rows,
    )
    from cuda_acceleratedvectordatabaseengine.storage import ArrowStorage

    t0 = time.time()
    if args.source:
        n_total = ArrowStorage.num_rows(args.source)
        # one slice, just for the dimension — not a whole-file read
        _, head = ArrowStorage.read_vectors(args.source, 0, 1)
        dim = head.shape[1]
        chunks = ArrowStorage.iter_vector_chunks(
            args.source, max(1, args.chunk_rows)
        )
    elif args.synthetic:
        if not args.dimension:
            p.error("--dimension required with --synthetic")
        rng = np.random.default_rng(args.seed)
        n_total, dim = args.synthetic, args.dimension

        def _synth():
            for off in range(0, n_total, max(1, args.chunk_rows)):
                m = min(args.chunk_rows, n_total - off)
                yield (
                    np.arange(off, off + m, dtype=np.uint64),
                    rng.standard_normal((m, dim)).astype(np.float32),
                )

        chunks = _synth()
    else:
        p.error("need --source or --synthetic")
    t_load = time.time() - t0
    print(f"[build] {n_total} vectors, dim {dim} (scan {t_load:.1f}s)")

    if args.pq_m:
        index = IVFPQIndex(IVFPQConfig(
            dimension=dim, nlist=args.nlist, m=args.pq_m,
            nbits=args.pq_nbits, metric=args.metric, opq=args.opq,
        ))
    else:
        index = IVFFlatIndex(IVFFlatConfig(
            dimension=dim, nlist=args.nlist, metric=args.metric,
            dtype=args.dtype,
        ))
    t0 = time.time()
    if args.source:
        sample = ArrowStorage.read_train_sample(
            args.source, min(train_sample_rows(index.config), n_total)
        )
    else:
        sample = np.random.default_rng(args.seed + 1).standard_normal(
            (min(train_sample_rows(index.config), n_total), dim)
        ).astype(np.float32)
    index.train(sample)
    t_train = time.time() - t0
    t0 = time.time()
    built = build_index_chunked(
        index, chunks, n_total,
        progress=lambda f: print(f"[build] ingest {f:.0%}", flush=True),
    )
    t_add = time.time() - t0
    print(f"[build] train {t_train:.1f}s, ingest {t_add:.1f}s "
          f"({built / max(t_add, 1e-9):.0f} vec/s)")

    out_dir = args.output
    epoch_id = ""
    if args.epoch_base:
        from cuda_acceleratedvectordatabaseengine.storage import (
            EpochManager,
        )

        em = EpochManager(args.epoch_base)
        epoch_id, out_dir = em.create_epoch(args.index_name)
    t0 = time.time()
    index.save(out_dir)
    print(f"[build] snapshot → {out_dir} (save {time.time() - t0:.1f}s)")
    print(json.dumps({
        "vectors": int(built),
        "dimension": dim,
        "nlist": args.nlist,
        "pq_m": args.pq_m,
        "train_s": round(t_train, 2),
        "add_s": round(t_add, 2),
        "snapshot": out_dir,
        "epoch": epoch_id,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
