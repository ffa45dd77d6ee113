"""Offline coarse-quantizer quality iteration (CPU, ~1 min/config).

Measures the thing the headline bench showed is binding: PROBE COVERAGE —
for ball-structured data, the fraction of same-ball points (the true
neighbors) whose assigned list lands in a query's nprobe probe set.

Usage: python scripts/dev_kmeans_probe.py [--iters 10] [--nprobe 32]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=250_000)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--nballs", type=int, default=512)
    p.add_argument("--k", type=int, default=512, help="centroids")
    p.add_argument("--nprobe", type=int, default=32)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--noise", type=float, default=0.25)
    p.add_argument("--nq", type=int, default=512)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from cuda_acceleratedvectordatabaseengine.ops.distance import (
        Metric,
        pairwise_distance,
    )
    from cuda_acceleratedvectordatabaseengine.ops.kmeans import (
        kmeans_assign,
        kmeans_fit,
    )
    from cuda_acceleratedvectordatabaseengine.ops.topk import topk_smallest

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((args.nballs, args.dim)).astype(np.float32)
    ball = np.arange(args.n) % args.nballs
    x = centers[ball] + args.noise * rng.standard_normal(
        (args.n, args.dim)
    ).astype(np.float32)
    x_d = jnp.asarray(x)

    t0 = time.time()
    cents, _ = kmeans_fit(
        jax.random.PRNGKey(42), x_d, args.k, iters=args.iters
    )
    cents.block_until_ready()
    t_fit = time.time() - t0
    # The bench's actual placement: capacity-clamped balanced 4-choice
    # assignment — spills from shared lists are what probes miss.
    from cuda_acceleratedvectordatabaseengine.models.ivf_flat import (
        _balance_assignments,
    )
    from cuda_acceleratedvectordatabaseengine.ops.kmeans import (
        kmeans_assign_topk,
    )

    capacity = -(-int(args.n / args.k * 1.35) // 128) * 128
    choices = np.asarray(kmeans_assign_topk(x_d, cents, 4, Metric.L2))
    assigns = _balance_assignments(choices, capacity, args.k)
    displaced = float((assigns != choices[:, 0]).mean())

    # Queries: perturbed points, one per sampled ball row.
    qi = rng.integers(0, args.n, args.nq)
    q = x[qi] + 0.1 * rng.standard_normal(
        (args.nq, args.dim)
    ).astype(np.float32)
    coarse = pairwise_distance(jnp.asarray(q), cents, Metric.L2)
    _, probe = topk_smallest(coarse, args.nprobe)
    probe = np.asarray(probe)

    # Exact true top-10 within the query's ball (true neighbors are always
    # same-ball at this separation): rank ball members by distance.
    k_at = 10
    cov = []
    for i in range(args.nq):
        members = np.flatnonzero(ball == ball[qi[i]])
        d = ((x[members] - q[i]) ** 2).sum(-1)
        top = members[np.argsort(d)[:k_at]]
        cov.append(np.isin(assigns[top], probe[i]).mean())
    coverage = float(np.mean(cov))

    # Structure diagnostics.
    cents_h = np.asarray(cents)
    d_ball_cent = ((centers[:, None, :18] - cents_h[None, :, :18]) ** 2).sum(-1)  # noqa: E501  (first 18 dims — cheap proxy)
    # full-dim min distance ball->centroid, chunked
    mind = np.empty(args.nballs)
    for b0 in range(0, args.nballs, 64):
        d = ((centers[b0:b0 + 64, None] - cents_h[None]) ** 2).sum(-1)
        mind[b0:b0 + 64] = d.min(-1)
    ball_radius2 = args.noise ** 2 * args.dim
    orphan = (mind > 4 * ball_radius2).sum()
    counts = np.bincount(assigns, minlength=args.k)
    # per-ball list concentration: fraction of a ball's points in its top list
    conc = []
    for b in range(args.nballs):
        a = assigns[ball == b]
        conc.append(np.bincount(a, minlength=args.k).max() / a.size)

    shared = int((counts > 1.5 * args.n / args.k).sum())
    print(json.dumps({
        "coverage@{}".format(args.nprobe): round(coverage, 4),
        "displaced_frac": round(displaced, 4),
        "shared_lists": shared,
        "capacity": capacity,
        "orphan_balls": int(orphan),
        "fit_s": round(t_fit, 1),
        "counts_p50": int(np.percentile(counts, 50)),
        "counts_p99": int(np.percentile(counts, 99)),
        "counts_max": int(counts.max()),
        "empty_lists": int((counts == 0).sum()),
        "ball_concentration_p50": round(float(np.median(conc)), 3),
        "ball_concentration_p10": round(float(np.percentile(conc, 10)), 3),
        "iters": args.iters,
    }))


if __name__ == "__main__":
    main()
