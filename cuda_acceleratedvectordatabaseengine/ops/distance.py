"""Distance metrics in matmul form.

Counterpart of the reference's per-thread ``Distance<T>`` functors
(``engine/kernels.cuh:31-81``): instead of a scalar loop per (query, vector)
pair, every metric is expressed so its inner product is one
batched matmul with fp32 accumulation, and the elementwise remainder fuses
into it.

Semantics match the reference:
  - L2            → squared euclidean distance, no sqrt (``kernels.cuh:37-47``)
  - InnerProduct  → negated dot product, so smaller = closer (``kernels.cuh:52-60``)
  - Cosine        → 1 - cosine similarity with eps=1e-8 (``kernels.cuh:65-80``)
"""

from __future__ import annotations

import enum

import jax
import jax.numpy as jnp

COSINE_EPS = 1e-8


class Metric(enum.Enum):
    """Distance metric. String values match the reference's gRPC API surface
    (``proto/vdb.proto:21`` — "L2", "InnerProduct", "Cosine")."""

    L2 = "L2"
    INNER_PRODUCT = "InnerProduct"
    COSINE = "Cosine"

    @classmethod
    def parse(cls, name: str) -> "Metric":
        for m in cls:
            if m.value.lower() == str(name).lower():
                return m
        raise ValueError(f"unknown metric {name!r}; expected one of "
                         f"{[m.value for m in cls]}")


def squared_norms(x: jax.Array) -> jax.Array:
    """fp32 squared L2 norms along the last axis."""
    xf = x.astype(jnp.float32)
    return jnp.sum(xf * xf, axis=-1)


def _dots(q: jax.Array, x: jax.Array, compute_dtype) -> jax.Array:
    """q @ x.T with fp32 accumulation. q: [B, D], x: [N, D]."""
    return jax.lax.dot_general(
        q.astype(compute_dtype),
        x.astype(compute_dtype),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )


def pairwise_distance(
    q: jax.Array,
    x: jax.Array,
    metric: Metric = Metric.L2,
    x_sq: jax.Array | None = None,
    compute_dtype=None,
) -> jax.Array:
    """Pairwise distances between queries ``q [B, D]`` and points ``x [N, D]``.

    Returns ``[B, N]`` fp32 distances where smaller = closer for every metric
    (inner product is negated, cosine is ``1 - cos``), matching the ordering
    convention of the reference kernels (``engine/kernels.cuh:31-81``).

    ``x_sq`` optionally supplies precomputed fp32 squared norms of ``x`` (the
    IVF arena caches these); ``compute_dtype`` selects the matmul input dtype
    (default: ``x.dtype`` — store the corpus in bfloat16 to double effective
    HBM bandwidth).
    """
    cdtype = compute_dtype or x.dtype
    if metric == Metric.L2:
        dots = _dots(q, x, cdtype)
        q_sq = squared_norms(q)
        if x_sq is None:
            x_sq = squared_norms(x)
        d = q_sq[:, None] - 2.0 * dots + x_sq[None, :]
        return jnp.maximum(d, 0.0)
    elif metric == Metric.INNER_PRODUCT:
        return -_dots(q, x, cdtype)
    elif metric == Metric.COSINE:
        q_sq = squared_norms(q)
        if x_sq is None:
            x_sq = squared_norms(x)
        dots = _dots(q, x, cdtype)
        inv = jax.lax.rsqrt(q_sq[:, None] * x_sq[None, :] + COSINE_EPS)
        return 1.0 - dots * inv
    raise ValueError(f"unknown metric: {metric}")
