"""``vdb-tune`` — measured search-parameter autotuner.

The reference ships a static tuning table (nlist/nprobe by corpus size,
``/root/reference/README.md:154-167``) with no measurement behind it. This
tool replaces that guesswork: it loads a built snapshot, measures the probe
coverage curve on real (or sampled) queries via
:meth:`IVFFlatIndex.calibrate_nprobe`, picks the smallest ``nprobe``
meeting the coverage target, and optionally times throughput at the
recommended operating point. The result is a JSON recommendation that can
be dropped into ``SearchParams`` (or served via ``nprobe=0``, which uses
the persisted calibration).

Usage:
    vdb-tune --snapshot /data/snap [--queries q.npy]
             [--target-coverage 0.99] [--k 10] [--measure-qps]
             [--batch 512] [--output -]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _reference_static_nprobe(ntotal: int) -> int:
    """The reference's static tier table (README.md:154-167)."""
    if ntotal < 1_000_000:
        return 16
    if ntotal <= 100_000_000:
        return 32
    return 64


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Search-parameter autotuner")
    p.add_argument("--snapshot", required=True,
                   help="index snapshot directory (IVFFlatIndex.save)")
    p.add_argument("--queries", default="",
                   help=".npy file of held-out queries [n, dim]; default "
                        "samples stored rows (slightly optimistic)")
    p.add_argument("--target-coverage", type=float, default=0.99)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--sample", type=int, default=512,
                   help="stored-row sample size when no --queries given")
    p.add_argument("--candidates", type=int, nargs="+",
                   default=[4, 8, 12, 16, 24, 32, 48, 64, 96, 128])
    p.add_argument("--measure-qps", action="store_true",
                   help="time throughput at the recommended nprobe")
    p.add_argument("--batch", type=int, default=512,
                   help="query batch size for --measure-qps")
    p.add_argument("--qps-batches", type=int, default=8)
    p.add_argument("--persist", action="store_true",
                   help="write the calibrated nprobe into the snapshot's "
                        "manifest so servers recovering this epoch serve "
                        "nprobe=0 requests with the tuned value")
    p.add_argument("--output", default="-",
                   help="JSON output path, '-' = stdout")
    args = p.parse_args(argv)

    from cuda_acceleratedvectordatabaseengine import (
        IVFFlatIndex,
        SearchParams,
    )
    from cuda_acceleratedvectordatabaseengine.models.ivf_pq import (
        IVFPQIndex,
    )
    from cuda_acceleratedvectordatabaseengine.storage.manifest import (
        IndexManifest,
    )

    man = IndexManifest.load(args.snapshot)
    if man.kind == "ivf_flat":
        idx = IVFFlatIndex.load(args.snapshot)
    elif man.kind == "ivf_pq":
        idx = IVFPQIndex.load(args.snapshot)
    else:
        raise SystemExit(f"cannot tune snapshot kind {man.kind!r}")
    queries = None
    if args.queries:
        queries = np.load(args.queries).astype(np.float32)
        if queries.ndim != 2 or queries.shape[1] != idx.config.dimension:
            raise SystemExit(
                f"--queries must be [n, {idx.config.dimension}], "
                f"got {queries.shape}"
            )

    cal = idx.calibrate_nprobe(
        queries=queries,
        target_coverage=args.target_coverage,
        k=args.k,
        candidates=tuple(sorted(set(args.candidates))),
        sample=args.sample,
    )

    report = {
        "snapshot": args.snapshot,
        "kind": man.kind,
        "ntotal": idx.ntotal,
        "nlist": idx.config.nlist,
        "dimension": idx.config.dimension,
        "arena_dtype": str(
            getattr(idx.config, "dtype", None)
            or getattr(idx.config, "raw_dtype", "")
        ),
        "k": args.k,
        "query_source": ("file" if args.queries else "sampled stored rows "
                         "(coverage slightly optimistic; prefer held-out "
                         "queries)"),
        "target_coverage": args.target_coverage,
        "recommended_nprobe": cal["nprobe"],
        "measured_coverage": round(float(cal["coverage"]), 4),
        # True when coverage plateaus below target (duplicated-mass
        # geometry) and the knee was chosen instead — see
        # IVFFlatIndex.calibrate_nprobe.
        "coverage_limited": bool(cal.get("coverage_limited", False)),
        "coverage_curve": {
            str(np_): round(float(c), 4) for np_, c in cal["curve"].items()
        },
        "reference_static_nprobe": _reference_static_nprobe(idx.ntotal),
    }

    if args.measure_qps:
        if queries is not None:
            # held-out queries, tiled up to the batch size if short
            reps = -(-args.batch // queries.shape[0])
            qb = np.tile(queries, (reps, 1))[: args.batch]
        else:
            # The calibration's stand-in workload: sampled stored rows.
            # (Gaussian noise probes near-uniformly over lists and would
            # report a QPS the recommended nprobe never serves at.)
            from cuda_acceleratedvectordatabaseengine.models.calibrate import (  # noqa: E501
                sample_stored_rows,
            )

            arena = getattr(idx, "arena", None)
            if arena is None:
                arena = getattr(idx, "raw", None)  # IVF-PQ keep_raw=True
            qb = sample_stored_rows(arena, args.batch, seed=1)
            if getattr(idx, "opq_R", None) is not None:
                # raw rows live in the OPQ frame; rotate back so the
                # search path applies the boundary transform once
                qb = qb @ np.asarray(idx.opq_R).T
        params = SearchParams(nprobe=cal["nprobe"], k=args.k)
        idx.search(qb, params)  # warm the executable
        t0 = time.monotonic()
        for _ in range(args.qps_batches):
            d, ids = idx.search(qb, params)
        dt = time.monotonic() - t0
        # Sequential blocking searches: each idx.search fetches its result
        # device→host before the next dispatch, so this under-reports the
        # pipelined serving throughput (bench.py's async-wave numbers).
        # Labeled accordingly so the two are never compared directly.
        report["sequential_qps"] = round(
            args.batch * args.qps_batches / dt, 1
        )
        report["batch"] = args.batch
        report["ms_per_batch_sequential"] = round(
            dt / args.qps_batches * 1000, 2
        )

    if args.persist:
        from cuda_acceleratedvectordatabaseengine.storage.manifest import (  # noqa: E501
            IndexManifest,
        )

        man = IndexManifest.load(args.snapshot)
        man.extra["calibrated_nprobe"] = int(cal["nprobe"])
        man.save(args.snapshot)
        report["persisted"] = True

    text = json.dumps(report, indent=2)
    if args.output == "-":
        print(text)
    else:
        with open(args.output, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
